"""The port's exclusion host path against the JAX package's, on the CPU:
``ExclusionContainer`` (rasters from files, code filters, invert, buffers,
nodata, ``allow_no_overlap``, geometry layers with their CRS),
``shape_availability``, ``shape_availability_reprojected``,
``build_exclusion_mask``, the code-selection helpers and
``compute_availabilitymatrix(backend="host")`` with the shapes' index, on
the cases of tests/test_gis.py (exclusions and availability matrices) and
the checks those cases make.  The ``"auto"`` backend of a CPU cutout is
the host path; a buffered raster layer takes the device path under
``"device"`` and, on a card, under ``"auto"``, cropped as the host path
crops it.

Both packages run the same float64 numpy here: masks, transforms and
availability matrices must be equal bit for bit.
"""

import logging

import jax
import numpy as np
import pandas as pd
import pytest
import torch

import atlite_tpu
from atlite_tpu.core.grid import Affine as JAffine
from atlite_tpu.gis import exclusion as jexcl
from atlite_tpu.gis import geometry as JG
from atlite_tpu.gis import raster as jraster
import atlite_tpu_torch
from atlite_tpu_torch.core.grid import Affine
from atlite_tpu_torch.gis import exclusion as texcl
from atlite_tpu_torch.gis import geometry as TG
from atlite_tpu_torch.gis import raster as traster
from atlite_tpu_torch.gis.crs import transform_points

torch.set_num_threads(1)

X0, Y0, X1, Y1 = -4.0, 56.0, 1.5, 61.0
RASTER_CLIP = 0.25
BOUNDS = dict(module="synthetic", bounds=(-4, 56, 1.5, 62), time="2013-01-01")


def make_rasters():
    transform, shape = traster.padded_transform_and_shape((X0, Y0, X1, Y1), 0.01)
    rng = np.random.default_rng(0)
    out = {"half": ((rng.random(shape) < RASTER_CLIP).astype(np.int32), transform, 4326)}
    rng = np.random.default_rng(1)
    out["codes"] = ((rng.random(shape) * 100).astype(np.int32), transform, 4326)
    x, y = transform_points(np.array([X0, X0, X1, X1]), np.array([Y0, Y1, Y0, Y1]), 4326, 3035)
    t3035, s3035 = traster.padded_transform_and_shape(
        (x.min() - 5e4, y.min() - 5e4, x.max() + 5e4, y.max() + 5e4), 1000)
    rng = np.random.default_rng(2)
    out["3035"] = ((rng.random(s3035) < RASTER_CLIP).astype(np.int32), t3035, 3035)
    return out


RASTERS = make_rasters()


def port_raster(name):
    data, t, crs = RASTERS[name]
    return traster.Raster(data, t, crs, 255)


def jax_raster(name):
    data, t, crs = RASTERS[name]
    return jraster.Raster(data, JAffine(*t), crs, 255)


def jgeom(g):
    return JG.parse_geometry(g.__geo_interface__)


def build(pkg, spec):
    """The excluder of ``spec`` in the port ("port") or the JAX package:
    (crs, res, [("raster", name, kwargs) | ("geometry", geoms, kwargs)])."""
    crs, res, layers = spec
    mod = texcl if pkg == "port" else jexcl
    exc = mod.ExclusionContainer(crs, res=res)
    for kind, what, kw in layers:
        if kind == "raster":
            exc.add_raster(port_raster(what) if pkg == "port" else jax_raster(what), **kw)
        else:
            exc.add_geometry(what if pkg == "port" else [jgeom(g) for g in what], **kw)
    return exc


FULL = [TG.box(X0, Y0, X1, Y1)]
QUARTER = [TG.box(X0 / 2 + X1 / 2, Y0 / 2 + Y1 / 2, X1, Y1)]
HALF_BOUNDS = (X0 - 2, Y0, X0 + 2, Y1)
FAR = (X0 - 10.0, Y0 - 10.0, X0 - 2.0, Y0 - 2.0)
HOLE = TG.box(X0 + 1.4, Y0 + 1.4, X0 + 1.6, Y0 + 1.6)

# name -> (shapes, excluder spec, check of the port's mask, or None);
# the cases of tests/test_gis.py's exclusion tests
CASES = {
    "area-3035": ([TG.box(X0 + 1, Y0 + 1, X1 - 1, Y1 - 1)], (3035, 300, []),
                  lambda m: np.isclose(m.sum() * 300**2, TG.transform_geometry(
                      TG.box(X0 + 1, Y0 + 1, X1 - 1, Y1 - 1), 4326, 3035).area, rtol=5e-3)),
    "geometry-quarter": (FULL, (4326, 0.01, [("geometry", QUARTER, {})]),
                         lambda m: np.isclose(3 * 27.5 / 4, m.sum() * 1e-4, rtol=1e-2)),
    "geometry-quarter-invert": (FULL, (4326, 0.01, [("geometry", QUARTER, dict(invert=True))]),
                                lambda m: np.isclose(27.5 / 4, m.sum() * 1e-4, rtol=1e-2)),
    "geometry-buffer": (FULL, (4326, 0.01, [("geometry", QUARTER, dict(buffer=0.05))]), None),
    "raster-half": (FULL, (4326, 0.01, [("raster", "half", {})]),
                    lambda m: round(m.sum() / m.size, 2) == 1 - RASTER_CLIP),
    "raster-half-invert": (FULL, (4326, 0.01, [("raster", "half", dict(invert=True))]),
                           lambda m: round(m.sum() / m.size, 2) == RASTER_CLIP),
    "raster-half-buffer": (FULL, (4326, 0.01, [("raster", "half", dict(buffer=0.01))]),
                           lambda m: m.sum() / m.size < 1 - RASTER_CLIP),
    "partial-overlap-codes": ([TG.box(*HALF_BOUNDS)],
                              (4326, 0.01, [("raster", "half", dict(codes=[0, 1]))]),
                              lambda m: np.isclose(m.sum() * 1e-4, 4 * 5 / 2, rtol=1e-2)),
    "partial-overlap-nodata0": ([TG.box(*HALF_BOUNDS)],
                                (4326, 0.01, [("raster", "half", dict(nodata=0))]),
                                lambda m: m.sum() * 1e-4 > 4 * 5 / 2),
    "partial-overlap-nodata1": ([TG.box(*HALF_BOUNDS)],
                                (4326, 0.01, [("raster", "half", dict(nodata=1))]),
                                lambda m: m.sum() * 1e-4 < 4 * 5 / 2),
    "no-overlap-allowed": ([TG.box(*FAR)],
                           (4326, 0.01, [("raster", "half", dict(allow_no_overlap=True))]),
                           lambda m: (m == 0).all()),
    "no-overlap-codes-invert": ([TG.box(*FAR)], (4326, 0.01, [("raster", "half", dict(
        allow_no_overlap=True, codes=[1, 255], invert=True))]),
                                lambda m: np.isclose(m.sum() * 1e-4, 64.0, rtol=1e-6)),
    "no-overlap-nodata0": ([TG.box(*FAR)], (4326, 0.01, [("raster", "half", dict(
        allow_no_overlap=True, nodata=0))]), lambda m: np.isclose(m.sum() * 1e-4, 64.0, rtol=1e-6)),
    "codes-range": (FULL, (4326, 0.01, [("raster", "codes", dict(codes=range(20)))]),
                    lambda m: round(m.sum() / m.size, 1) == 0.8),
    "codes-range-invert": (FULL, (4326, 0.01, [("raster", "codes", dict(codes=range(20),
                                                                        invert=True))]),
                           lambda m: round(m.sum() / m.size, 1) == 0.2),
    "codes-callable-invert": (FULL, (4326, 0.01, [("raster", "codes", dict(
        codes=lambda x: x < 20, invert=True))]), lambda m: round(m.sum() / m.size, 1) == 0.2),
    "raster-3035": ([TG.box(X0 + 1, Y0 + 1, X1 - 1, Y1 - 1)],
                    (3035, 500, [("raster", "3035", {})]), None),
    "geometry-crs-4326": ([TG.box(X0 + 1, Y0 + 1, X0 + 2, Y0 + 2)],
                          (3035, 500, [("geometry", [HOLE], dict(crs=4326))]), None),
    "geometry-projected": ([TG.box(X0 + 1, Y0 + 1, X0 + 2, Y0 + 2)],
                           (3035, 500, [("geometry", [TG.transform_geometry(HOLE, 4326, 3035)],
                                         {})]), None),
    "mixed-layers": ([TG.box(X0 + 0.5, Y0 + 0.5, X1 - 0.5, Y1 - 0.5)],
                     (4326, 0.01, [("raster", "codes", dict(codes=[3, 4, 5], buffer=0.02)),
                                   ("raster", "half", dict(invert=True)),
                                   ("geometry", QUARTER, dict(invert=True, buffer=0.03))]), None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_shape_availability(case):
    shapes, spec, check = CASES[case]
    got, gt = texcl.shape_availability(shapes, build("port", spec), geometry_crs=4326)
    want, wt = jexcl.shape_availability([jgeom(g) for g in shapes], build("jax", spec),
                                        geometry_crs=4326)
    assert got.dtype == want.dtype == bool
    np.testing.assert_array_equal(got, want)
    assert tuple(gt) == tuple(wt)
    if check is not None:
        assert check(got)


def test_no_overlap_raises():
    shapes = [TG.box(*FAR)]
    for pkg, mod, geoms in (("port", texcl, shapes), ("jax", jexcl, [jgeom(shapes[0])])):
        with pytest.raises(ValueError, match="do not overlap"):
            mod.shape_availability(geoms, build(pkg, (4326, 0.01, [("raster", "half", {})])),
                                   geometry_crs=4326)


def test_geometry_crs_reprojection_bites():
    """A lon/lat exclusion polygon added to a metric excluder excludes; a
    plain geometry is taken as already projected (tests/test_gis.py)."""
    shapes = CASES["geometry-crs-4326"][0]
    masked, _ = texcl.shape_availability(shapes, build("port", CASES["geometry-crs-4326"][1]), 4326)
    full, _ = texcl.shape_availability(shapes, texcl.ExclusionContainer(3035, res=500), 4326)
    assert masked.sum() < full.sum() * 0.985
    projected, _ = texcl.shape_availability(shapes, build("port", CASES["geometry-projected"][1]),
                                            4326)
    np.testing.assert_array_equal(masked, projected)


@pytest.mark.parametrize("case", ["raster-half", "codes-range", "raster-3035", "mixed-layers"])
def test_shape_availability_reprojected(case):
    shapes, spec, _ = CASES[case]
    dst = Affine(0.25, 0, X0 - 0.125, 0, -0.25, 62.125)
    got, _ = texcl.shape_availability_reprojected(shapes, build("port", spec), dst, 4326,
                                                  (25, 23), geometry_crs=4326)
    want, _ = jexcl.shape_availability_reprojected([jgeom(g) for g in shapes],
                                                   build("jax", spec), JAffine(*dst), 4326,
                                                   (25, 23), geometry_crs=4326)
    np.testing.assert_array_equal(got, want)
    assert (got > 0).any()


@pytest.mark.parametrize("case", ["raster-half", "codes-callable-invert", "mixed-layers",
                                  "geometry-crs-4326"])
def test_build_exclusion_mask(case):
    shapes, spec, _ = CASES[case]
    crs, res, _ = spec
    bounds = TG.transform_geometry(shapes[0], 4326, crs).bounds
    t, shape = traster.padded_transform_and_shape(bounds, res)
    for crop in (None, shapes):
        got = texcl.build_exclusion_mask(build("port", spec), t, shape,
                                         crop_geoms=None if crop is None else
                                         [TG.transform_geometry(g, 4326, crs) for g in crop])
        want = jexcl.build_exclusion_mask(
            build("jax", spec), JAffine(*t), shape,
            crop_geoms=None if crop is None else
            [jgeom(TG.transform_geometry(g, 4326, crs)) for g in crop])
        np.testing.assert_array_equal(got, want)


def test_code_select_and_nodata():
    rng = np.random.default_rng(0)
    for dtype in (np.uint8, np.int16, np.uint16, np.int32, np.float32):
        info = np.iinfo(dtype) if np.dtype(dtype).kind in "ui" else None
        vals = (rng.integers(info.min, info.max, (40, 30)) if info else
                rng.integers(0, 9, (40, 30))).astype(dtype)
        for codes in (None, [3], [0, 5, 7], [1, 100000], [2.0, 4.5]):
            np.testing.assert_array_equal(texcl._code_select(vals, codes),
                                          jexcl._code_select(vals, codes))
        top = info.max if info else 255
        for nodata, codes in ((top, [top]), (top, [top - 65536]), (3, None), (0, [1])):
            d = dict(raster=traster.Raster(vals, Affine(1, 0, 0, 0, -1, 0), 4326, nodata),
                     codes=codes, nodata=nodata)
            jd = dict(d, raster=jraster.Raster(vals, JAffine(1, 0, 0, 0, -1, 0), 4326, nodata))
            assert texcl._nodata_selected(d) == jexcl._nodata_selected(jd)


def test_bounds_overlap_and_geometry_list():
    r = port_raster("3035")
    for window, crs in (((X0, Y0, X1, Y1), 4326), ((X1 + 5, Y0, X1 + 6, Y1), 4326),
                        ((3.5e6, 3.7e6, 3.6e6, 3.8e6), 3035)):
        assert texcl._bounds_overlap(r, window, crs) == jexcl._bounds_overlap(
            jax_raster("3035"), window, crs)
    series = pd.Series({"a": QUARTER[0], "b": HOLE})
    for shapes, n in ((QUARTER[0], 1), ({"a": QUARTER[0], "b": HOLE}, 2), (series, 2),
                      (QUARTER[0].__geo_interface__, 1)):
        got = texcl._as_geometry_list(shapes, 4326, 3035)
        assert len(got) == n
        np.testing.assert_array_equal(got[-1].shell, TG.transform_geometry(
            TG.parse_geometry(HOLE if n == 2 else QUARTER[0]), 4326, 3035).shell)


def test_open_files_and_repr(tmp_path):
    path = tmp_path / "r.npz"
    port_raster("half").save(path)
    exc = texcl.ExclusionContainer(4326, res=0.01)
    assert exc.all_closed and exc.all_open
    exc.add_raster(path)
    exc.add_geometry(str(tmp_path / "later.geojson"))
    assert exc.all_closed and not exc.all_open
    exc.geometries.clear()
    exc.open_files()
    assert exc.all_open and not exc.all_closed
    assert isinstance(exc.rasters[0]["raster"], traster.Raster)
    jexc = jexcl.ExclusionContainer(4326, res=0.01)
    jexc.add_raster(path)
    assert repr(exc) == repr(jexc)
    # a per-layer CRS relabels a copy, never the caller's raster
    r = traster.Raster(np.ones((5, 5), np.uint8), Affine(100, 0, 4.3e6, 0, -100, 3.6e6), 4326,
                       255)
    exc = texcl.ExclusionContainer(3035, res=100)
    exc.add_raster(r, crs=3035)
    exc.open_files()
    assert r.crs == 4326 and exc.rasters[0]["raster"].crs == 3035
    with pytest.raises(TypeError, match="transform"):
        bad = texcl.ExclusionContainer()
        bad.add_raster(np.ones((3, 3)))
        bad.open_files()


def test_compute_shape_availability_argument_rules():
    exc = build("port", CASES["raster-half"][1])
    with pytest.raises(ValueError, match="all None or all defined"):
        exc.compute_shape_availability(FULL, dst_transform=Affine(1, 0, 0, 0, -1, 0))
    a, _ = exc.compute_shape_availability(FULL)
    b, _ = texcl.shape_availability(FULL, build("port", CASES["raster-half"][1]), 4326)
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def cutouts():
    with jax.enable_x64(False):
        jc = atlite_tpu.Cutout(path=None, **BOUNDS)
    return jc, atlite_tpu_torch.Cutout(device="cpu", **BOUNDS)


def series(boxes):
    return pd.Series(boxes).rename_axis("shape")


TWO = [TG.box(X0 + 1, Y0 + 1, X1 - 1, Y0 / 2 + Y1 / 2),
       TG.box(X0 + 1, Y0 / 2 + Y1 / 2, X1 - 1, Y1 - 1)]

# name -> (shapes, excluder spec, check against the indicator matrix I);
# the availability-matrix cases of tests/test_gis.py
MATRIX_CASES = {
    "flat": ([TG.box(X0 + 1, Y0 + 1, X1 - 1, Y1 - 1)], (4326, 0.01, []),
             lambda I, a: np.allclose(I.sum(0), a.sum(0), atol=0.02)),
    "rastered": (TWO, (4326, 0.01, [("raster", "half", {})]),
                 lambda I, a: np.isclose(I.sum() * (1 - RASTER_CLIP), a.sum(), atol=5)),
    "rastered-repro": (TWO, (3035, 300, [("raster", "3035", {})]),
                       lambda I, a: np.isclose(I.sum() * (1 - RASTER_CLIP), a.sum(), atol=5)),
    "buffered-codes": (TWO, (4326, 0.01, [("raster", "codes", dict(codes=range(30), buffer=0.01))]),
                       lambda I, a: a.sum() < I.sum() * 0.7),
}


@pytest.mark.parametrize("case", sorted(MATRIX_CASES))
def test_availabilitymatrix_host(cutouts, case):
    jc, tc = cutouts
    shapes, spec, check = MATRIX_CASES[case]
    got = tc.availabilitymatrix(series(shapes), build("port", spec))  # CPU cutout: auto = host
    want = jc.availabilitymatrix(series([jgeom(g) for g in shapes]), build("jax", spec),
                                 backend="host")
    assert got.dims == want.dims == ("shape", "y", "x")
    assert isinstance(got.values, np.ndarray)
    np.testing.assert_array_equal(got.values, np.asarray(want.values))
    for d in ("y", "x"):
        np.testing.assert_array_equal(got.coords[d], np.asarray(want.coords[d]))
    assert np.all(np.diff(got.coords["y"]) > 0)
    I = np.asarray(tc.indicatormatrix(shapes).todense()).reshape((len(shapes),) + tc.shape)
    assert check(I, got.values)


def test_availabilitymatrix_index_forms(cutouts):
    """A Series keeps its index, a dict its keys, a list 0..n-1."""
    jc, tc = cutouts
    spec = (4326, 0.05, [("raster", "half", {})])
    named = pd.Series(TWO, index=["north", "south"])
    for shapes, labels in ((named, ["north", "south"]), (dict(zip("ab", TWO)), ["a", "b"]),
                           (TWO, [0, 1])):
        got = texcl.compute_availabilitymatrix(tc, shapes, build("port", spec), backend="host")
        assert list(got.coords["shape"]) == labels
    want = jexcl.compute_availabilitymatrix(jc, named.map(jgeom), build("jax", spec),
                                            backend="host")
    np.testing.assert_array_equal(texcl.compute_availabilitymatrix(
        tc, named, build("port", spec), backend="host").values, np.asarray(want.values))
    with pytest.raises(ValueError, match="unknown backend"):
        texcl.compute_availabilitymatrix(tc, TWO, build("port", spec), backend="tpu")


def test_buffered_raster_crop_semantics_and_routing(caplog, monkeypatch):
    """atlite crops each raster to the query shape before dilation: a code
    pixel outside the shape does not buffer into it.  The device path
    crops so too: on a CPU cutout under "device", and under "auto" on a
    cutout whose device reads as a card, it runs (no refusal, no host
    fallback) and equals the host path."""
    from atlite_tpu_torch.gis import kernels

    res = 0.01
    shape_geom = [TG.box(0.0, 0.0, 1.0, 1.0)]
    arr = np.zeros((120, 140), np.int32)
    arr[:, int((1.002 + 0.2) / res):int((1.05 + 0.2) / res)] = 1
    r = traster.Raster(arr, Affine(res, 0, -0.2, 0, -res, 1.1), 4326, 255)

    def exc():
        e = texcl.ExclusionContainer(4326, res=res)
        e.add_raster(r, codes=[1], buffer=5 * res)
        return e

    masked, _ = texcl.shape_availability(shape_geom, exc(), geometry_crs=4326)
    base, _ = texcl.shape_availability(shape_geom, texcl.ExclusionContainer(4326, res=res), 4326)
    assert masked.sum() == base.sum()
    cut = atlite_tpu_torch.Cutout(device="cpu", module="synthetic", x=slice(0.0, 1.0),
                                  y=slice(0.0, 1.0), time="2013-01-01")
    host = cut.availabilitymatrix(shape_geom, exc(), backend="host").values
    device = cut.availabilitymatrix(shape_geom, exc(), backend="device").values
    # one CRS: the device's two float32 overlap products against float64
    np.testing.assert_allclose(device, host, rtol=0, atol=1e-6)
    # a cutout whose device reads as a card takes the device path under
    # "auto" (run here on the CPU): no refusal, no host fallback
    real, seen = kernels.availability_matrix_device, []

    def on_the_cpu(cutout, *args, **kwargs):
        seen.append(cutout.device.type)
        cutout.device = torch.device("cpu")
        try:
            return real(cutout, *args, **kwargs)
        finally:
            cutout.device = torch.device("cuda")

    monkeypatch.setattr(kernels, "availability_matrix_device", on_the_cpu)
    cut.device = torch.device("cuda")
    try:
        with caplog.at_level(logging.INFO, logger="atlite_tpu_torch.gis.exclusion"):
            auto = cut.availabilitymatrix(shape_geom, exc()).values
    finally:
        cut.device = torch.device("cpu")
    assert seen == ["cuda"] and "host path" not in caplog.text
    np.testing.assert_array_equal(auto, device)
    assert np.isfinite(host).all()


def test_family_less_crs_matches_3035():
    """An exclusion raster in EPSG:2056 (no closed form: the host path's
    system-PROJ fallback) equals the JAX package's, and matches the same
    physical mask rastered in EPSG:3035 (tests/test_gis.py)."""
    import shutil

    if shutil.which("cs2cs") is None or shutil.which("projinfo") is None:
        pytest.skip("the system PROJ (cs2cs, projinfo) is not installed")
    kw = dict(module="synthetic", x=slice(7.0, 9.0), y=slice(46.0, 47.0), time="2013-01-01")
    tc = atlite_tpu_torch.Cutout(device="cpu", **kw)
    jc = atlite_tpu.Cutout(path=None, **kw)

    def checker_raster(epsg, res):
        px, py = transform_points(np.array([7.0, 7.0, 9.0, 9.0]), np.array([46.0, 47.0] * 2),
                                  4326, epsg)
        t, shape = traster.padded_transform_and_shape(
            (px.min() - 5e3, py.min() - 5e3, px.max() + 5e3, py.max() + 5e3), res)
        xs = t.c + t.a * (np.arange(shape[1]) + 0.5)
        ys = t.f + t.e * (np.arange(shape[0]) + 0.5)
        lon, lat = transform_points(np.broadcast_to(xs, shape).ravel(),
                                    np.broadcast_to(ys[:, None], shape).ravel(), epsg, 4326)
        mask = ((np.floor(lon / 0.2) + np.floor(lat / 0.2)) % 2).astype(np.int32).reshape(shape)
        return mask, t

    shapes = [TG.box(7.1, 46.1, 8.0, 46.9), TG.box(8.0, 46.1, 8.9, 46.9)]
    results = {}
    for epsg in (3035, 2056):
        mask, t = checker_raster(epsg, 250)
        exc = texcl.ExclusionContainer(crs=epsg, res=250)
        exc.add_raster(traster.Raster(mask, t, epsg, 255), codes=[1])
        jexc = jexcl.ExclusionContainer(crs=epsg, res=250)
        jexc.add_raster(jraster.Raster(mask, JAffine(*t), epsg, 255), codes=[1])
        results[epsg] = tc.availabilitymatrix(series(shapes), exc, backend="host").values
        want = jc.availabilitymatrix(series([jgeom(g) for g in shapes]), jexc, backend="host")
        np.testing.assert_array_equal(results[epsg], np.asarray(want.values))
    a, b = results[3035], results[2056]
    assert np.abs(a - b).max() < 0.05


def test_plot_shape_availability():
    """The plot draws the same eligible-area image, outline and title as
    the JAX package's (matplotlib, imported only by this method)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    spec = CASES["mixed-layers"][1]
    shapes = [TG.box(X0 + 1, Y0 + 1, X0 + 2.5, Y0 + 2)]
    axes = []
    for pkg, geoms in (("port", shapes), ("jax", [jgeom(g) for g in shapes])):
        fig, ax = plt.subplots()
        axes.append(build(pkg, spec).plot_shape_availability(geoms, ax=ax))
    got, want = axes
    assert got.get_title() == want.get_title() and got.get_title().startswith("Eligible area")
    np.testing.assert_array_equal(got.images[0].get_array(), want.images[0].get_array())
    assert got.images[0].get_extent() == want.images[0].get_extent()
    np.testing.assert_array_equal(got.lines[0].get_xydata(), want.lines[0].get_xydata())
    plt.close("all")
