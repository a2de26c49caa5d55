"""Cutout creation, geometry and metadata: the cases of
``tests/test_creation.py`` on the port, each held against the JAX
object made from the same arguments (JAX with x64 on, as in that file,
for the float64 cutouts), plus ``Grid.dt`` against pandas' inference
through the JAX Grid, the feature tables and ``grid`` row by row, and
``coords``/``name``/``repr``.

Tolerance: coordinates, extents, transforms and tables exactly; the wind
series of the coarse float64 cutout rtol 1e-5 / atol 2e-5.
"""

import tempfile
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import atlite_tpu
from atlite_tpu.core import grid as jgrid
from atlite_tpu_torch import Cutout
from atlite_tpu_torch.core import grid as tgrid

torch.set_num_threads(1)

TIME = "2013-01-01"
BOUNDS = (-4, 56, 1.5, 62)


def pair(**kw):
    """(JAX cutout, port cutout) from the same arguments."""
    return atlite_tpu.Cutout(path=None, **kw), Cutout(device="cpu", **kw)


@pytest.fixture(scope="module")
def both():
    kw = dict(module="synthetic", bounds=BOUNDS, time=TIME, dtype="float64")
    j, t = pair(**kw)
    return j.prepare(), t.prepare()


@pytest.fixture(scope="module")
def coarse():
    j, t = pair(module="synthetic", bounds=BOUNDS, time=TIME, dx=0.5, dy=0.7, dtype="float64")
    return j.prepare(), t.prepare()


def same_grid(t, j):
    for k in ("x", "y", "time"):
        np.testing.assert_array_equal(getattr(t.grid_desc, k), getattr(j.grid_desc, k))
    assert t.shape == j.shape and t.dx == j.dx and t.dy == j.dy and t.dt == j.dt


def test_grid_shape_and_coords(both):
    j, t = both
    same_grid(t, j)
    assert t.shape == (25, 23)
    assert t.grid_desc.x[0] == -4 and t.grid_desc.x[-1] == 1.5
    assert t.grid_desc.y[0] == 56 and t.grid_desc.y[-1] == 62
    assert t.dx == 0.25 and t.dy == 0.25 and len(t.grid_desc.time) == 24
    for k in ("x", "y", "time"):
        assert isinstance(t.coords[k], np.ndarray)
        np.testing.assert_array_equal(t.coords[k], np.asarray(j.coords[k]))


def test_extent_bounds_transform(both):
    j, t = both
    np.testing.assert_array_equal(t.extent, j.extent)
    np.testing.assert_array_equal(t.bounds, j.bounds)
    np.testing.assert_allclose(t.extent, [-4.125, 1.625, 55.875, 62.125])
    assert tuple(t.transform) == tuple(j.transform)
    assert tuple(t.transform_r) == tuple(j.transform_r)
    assert t.transform.a == 0.25 and t.transform.f == 55.875
    assert t.transform_r.e == -0.25 and t.transform_r.f == 62.125
    for aff in ("transform", "transform_r"):
        ta, ja = getattr(t, aff), getattr(j, aff)
        assert ta * (3, 7) == ja * (3, 7)
        assert tuple(ta.inverse) == tuple(ja.inverse)
        assert ta.inverse * (ta * (3, 7)) == pytest.approx((3, 7))


def test_odd_bounds_snap_to_lattice():
    j, t = pair(module="synthetic", time=TIME, bounds=(-4.1, 56.2, 1.6, 61.8))
    same_grid(t, j)
    assert np.all(np.isclose(np.mod(t.grid_desc.x, 0.25), 0))
    assert t.grid_desc.x[0] >= -4.1 and t.grid_desc.x[-1] <= 1.6


def test_reversed_slices():
    t1 = Cutout(device="cpu", module="synthetic", time=TIME, x=slice(-4, 1.5), y=slice(56, 62))
    j2, t2 = pair(module="synthetic", time=TIME, x=slice(1.5, -4), y=slice(62, 56))
    same_grid(t2, j2)
    np.testing.assert_array_equal(t1.grid_desc.x, t2.grid_desc.x)
    np.testing.assert_array_equal(t1.grid_desc.y, t2.grid_desc.y)


def test_time_slice():
    j, t = pair(module="synthetic", bounds=BOUNDS, time=slice("2013-01-01", "2013-01-02"))
    same_grid(t, j)
    assert len(t.grid_desc.time) == 48
    assert t.grid_desc.time[0] == np.datetime64("2013-01-01T00:00", "ns")


def test_dt_sampling():
    j, t = pair(module="synthetic", bounds=BOUNDS, time=TIME, dt="3h")
    same_grid(t, j)
    assert len(t.grid_desc.time) == 8 and t.dt == "3h"


@pytest.mark.parametrize("time, want", [
    (pd.date_range("2013-01-01", periods=24, freq="h"), "h"),
    (pd.date_range("2013-01-01", periods=8, freq="3h"), "3h"),
    (pd.date_range("2013-01-01", periods=5, freq="D"), "D"),
    (pd.DatetimeIndex(["2013-01-01 00:00", "2013-01-01 06:00"]), "6h"),
    (pd.DatetimeIndex(["2013-01-01", "2013-01-02"]), "24h"),
    (pd.DatetimeIndex(["2013-01-01"]), None),
    (pd.DatetimeIndex(["2013-01-01 00:00", "2013-01-01 01:00", "2013-01-01 03:00"]), None),
], ids=["h", "3h", "D", "two stamps", "two days", "one stamp", "irregular"])
def test_grid_dt(time, want):
    """``dt`` as the JAX Grid (pandas' ``infer_freq``, or the step of two
    stamps through ``to_offset``) gives it."""
    x, y = np.arange(2.0), np.arange(2.0)
    jg = jgrid.Grid(x=x, y=y, time=time.values)
    tg = tgrid.Grid(x=x, y=y, time=time.values.astype("datetime64[ns]"))
    assert tg.dt == jg.dt == want


def test_available_and_prepared_features(both):
    j, t = both
    for attr in ("available_features", "prepared_features"):
        got, want = getattr(t, attr), getattr(j, attr)
        assert len(got) == len(want)
        assert got.rows() == [(i, v) for i, v in zip(want.index, want.values)]
        pd.testing.assert_series_equal(got.to_pandas(), want)
    assert {f for _, f in t.available_features.index} == {
        "height", "wind", "influx", "temperature", "runoff"}
    assert t.prepared and j.prepared
    assert "wnd100m" in t.data and "influx_toa" in t.data


def test_grid_dataframe(both):
    j, t = both
    got, want = t.grid, j.grid
    assert len(got) == len(want) == 25 * 23
    np.testing.assert_array_equal(got["x"], want.x.values)
    np.testing.assert_array_equal(got["y"], want.y.values)
    assert [g.bounds for g in got["geometry"]] == [g.bounds for g in want.geometry]
    assert got["x"][0] == -4 and got["x"][1] == -3.75 and got["y"][0] == 56
    np.testing.assert_allclose(got["geometry"][0].bounds, (-4.125, 55.875, -3.875, 56.125))
    df = got.to_pandas()
    pd.testing.assert_frame_equal(df[["x", "y"]], want[["x", "y"]])


def test_sel(both):
    j, t = both
    sub, jsub = t.sel(x=slice(-2, 0), y=slice(57, 59)), j.sel(x=slice(-2, 0), y=slice(57, 59))
    same_grid(sub, jsub)
    assert sub.device == t.device and sub.path is None
    assert sub.data["wnd100m"].shape[1:] == sub.shape
    for k in j.data:
        np.testing.assert_array_equal(sub.data[k], jsub.data[k])
    b, jb = t.sel(bounds=(-2, 57, 0, 59), buffer=0.25, time="2013-01-01 05:00"), \
        j.sel(bounds=(-2, 57, 0, 59), buffer=0.25, time="2013-01-01 05:00")
    same_grid(b, jb)
    assert len(b.grid_desc.time) == 1
    assert b.equals(t.sel(x=slice(-2.25, 0.25), y=slice(56.75, 59.25), time="2013-01-01 05"))
    assert not b.equals(jb)  # a JAX cutout is no port cutout


def test_store_roundtrip(tmp_path, both):
    j, t = both
    path = tmp_path / "c1.atc"
    t.to_file(path)
    c2 = Cutout(path, device="cpu")
    assert c2.equals(t) and c2.prepared
    c2.prepare()  # already prepared: nothing happens
    assert c2.equals(t)
    jc2 = atlite_tpu.Cutout(path=path)  # the JAX package reads it too
    assert jc2.equals(j)
    with pytest.warns(UserWarning, match="ignored"):
        Cutout(path, device="cpu", module="synthetic")
    with pytest.raises(TypeError, match="must be specified"):  # no .nc file there
        Cutout(tmp_path / "c1.nc", device="cpu")
    c2.to_file(tmp_path / "c1.nc")  # a .nc path writes NetCDF, which either package reads
    assert Cutout(tmp_path / "c1.nc", device="cpu").equals(t)
    assert atlite_tpu.Cutout(path=tmp_path / "c1.nc").equals(j)


def test_merge():
    kw = dict(module="synthetic", bounds=BOUNDS, time=TIME, dtype="float64")
    jw, tw = pair(**kw)
    ji, ti = pair(**kw)
    jw.prepare(features=["wind"]), tw.prepare(features=["wind"])
    ji.prepare(features=["influx"]), ti.prepare(features=["influx"])
    merged, jmerged = tw.merge(ti), jw.merge(ji)
    assert "wnd100m" in merged.data and "influx_toa" in merged.data
    assert list(merged.data) == list(jmerged.data)
    assert merged.attrs == jmerged.attrs and merged.device == tw.device
    for k in jmerged.data:
        np.testing.assert_array_equal(merged.data[k], jmerged.data[k])
    with pytest.raises(ValueError, match="different coordinates"):
        tw.merge(tw.sel(x=slice(-2, 0)))


def test_missing_params_raise():
    with pytest.raises(TypeError):
        atlite_tpu.Cutout(path=None, module="synthetic")
    with pytest.raises(TypeError):
        Cutout(device="cpu", module="synthetic")


def test_odd_resolution(coarse):
    j, t = coarse
    same_grid(t, j)
    assert t.dx == 0.5 and t.dy == 0.7
    assert np.all(np.isclose(np.diff(t.grid_desc.x), 0.5))
    assert np.all(np.isclose(np.diff(t.grid_desc.y), 0.7))
    cf = t.wind("Vestas_V112_3MW", aggregate_time=None)
    assert cf.values.shape == (24,) + t.shape
    want = np.asarray(j.wind("Vestas_V112_3MW", aggregate_time=None).values)
    np.testing.assert_allclose(cf.values, want, rtol=1e-5, atol=2e-5)


def test_weird_resolution_offsets():
    j, t = pair(module="synthetic", time=TIME, bounds=(-4.123, 56.234, 1.433, 61.876),
                dx=0.23, dy=0.31)
    same_grid(t, j)
    assert np.all(t.grid_desc.x >= -4.123) and np.all(t.grid_desc.x <= 1.433)
    assert len(t.grid_desc.x) > 0 and len(t.grid_desc.y) > 0


def test_prepare_cleans_auto_tmpdir(monkeypatch):
    made = []
    real_mkdtemp = tempfile.mkdtemp

    def spy_mkdtemp(*a, **kw):
        d = real_mkdtemp(*a, **kw)
        if kw.get("prefix") == "atlite_tpu_torch_prepare":
            made.append(d)
        return d

    monkeypatch.setattr(tempfile, "mkdtemp", spy_mkdtemp)
    c = Cutout(device="cpu", module="synthetic", bounds=(-4, 56, -3, 57), time=TIME)
    c.prepare(features=["wind"])
    assert made, "prepare() did not create its own tmpdir"
    assert not Path(made[0]).exists(), "prepare() leaked its tmpdir"


@pytest.mark.parametrize("label", ["2011Q1", "2011-01", "2011", "2011-1-5", "2011-02-28"])
def test_end_of_rejects_non_iso_partials(label):
    """'2011Q1' is not the whole year (JAX takes it as an instant, the port
    refuses it); a partial ISO label ends with its period, as in the JAX
    package, whose end pandas gives to the microsecond where the port
    gives it to the nanosecond."""
    want = np.datetime64(jgrid._end_of(label).as_unit("ns").value, "ns")
    if label == "2011Q1":
        assert want == np.datetime64("2011-01-01", "ns")
        with pytest.raises(ValueError):
            tgrid._end_of(label)
        return
    got = tgrid._end_of(label)
    assert want <= got < want + np.timedelta64(1, "us")
    assert got + np.timedelta64(1, "ns") == np.datetime64(got, "D") + np.timedelta64(1, "D")


def test_open_ended_time_slice():
    for time in (slice("2013-01-05", None), slice(None, "1940-01-02")):
        got = tgrid.coordinate_range(slice(-1, 0), slice(50, 51), time, 1.0, 1.0, "h")
        want = jgrid.coordinate_range(slice(-1, 0), slice(50, 51), time, 1.0, 1.0, "h")
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g, w)
        if time.start is not None:  # "now" moves between the two calls: compare the start
            assert got[2][0] == want[2][0] and len(got[2]) > 24
        else:
            np.testing.assert_array_equal(got[2], want[2])
            assert len(got[2]) == 48


def test_name_repr_and_grid_sel(both, tmp_path):
    j, t = both
    assert t.name == j.name == "<memory>"
    assert repr(t) == repr(j)
    c = Cutout(tmp_path / "named.v1", device="cpu", module="synthetic", bounds=BOUNDS, time=TIME)
    assert c.path == tmp_path / "named.atc" and c.name == "named"
    for kw in (dict(x=slice(0, -2)), dict(time="2013-01-01 05:00"),
               dict(y=slice(57, None), time=slice(None, "2013-01-01 04:00"))):
        g, w = t.grid_desc.sel(**kw), j.grid_desc.sel(**kw)
        for k in ("x", "y", "time"):
            np.testing.assert_array_equal(getattr(g, k), getattr(w, k))
    np.testing.assert_array_equal(t.grid_desc.cell_bounds(), j.grid_desc.cell_bounds())
    np.testing.assert_array_equal(t.grid_desc.cell_coords(), j.grid_desc.cell_coords())
