"""The port's SARAH, GEBCO, NCEP and CORDEX modules against the JAX
package's: SARAH file discovery by date (the same files matched, the
same refusals), ``open_archive`` on the checked-in SARAH-format NETCDF4
files (h5py-written: dimension scales, CF time, packed int16 with
night-time fill), the NaN interpolation and half-hour averaging, the
whole chain onto 0.05 deg and onto a coarser cutout (regridded), from
arrays and from the archive, ``.atc`` stores prepared from it (byte for
byte), GEBCO heights from a raster (in memory and from an ``.npz``) and
NCEP's array helpers.

Inputs come from numpy seeds and the checked-in archive.  Every
comparison is bit for bit; times as instants at ns (see
``tests/test_torch_netcdf.py``).
"""

import hashlib
from pathlib import Path

import jax
import numpy as np
import pytest

import atlite_tpu
import atlite_tpu_torch
from atlite_tpu.core.grid import Affine as JAffine
from atlite_tpu.datasets import cordex as jcordex
from atlite_tpu.datasets import gebco as jgebco
from atlite_tpu.datasets import ncep as jncep
from atlite_tpu.datasets import sarah as jsarah
from atlite_tpu.gis.raster import Raster as JRaster
from atlite_tpu_torch.core.grid import Affine
from atlite_tpu_torch.datasets import cordex, gebco, ncep, sarah
from atlite_tpu_torch.gis.raster import Raster

DATA = Path(__file__).parent / "data" / "sarah"
CUTOUT_KW = dict(x=slice(-4.95, -4.21), y=slice(56.05, 56.61),
                 time=slice("2013-05-01", "2013-05-02 23:00"), dx=0.05, dy=0.05)
COARSE_KW = dict(x=slice(-4.9, -4.31), y=slice(56.1, 56.51),
                 time=slice("2013-05-01", "2013-05-01 23:00"), dx=0.1, dy=0.1)


def same(got, want):
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            same(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            same(g, w)
    else:
        g, w = np.asarray(got), np.asarray(want)
        if w.dtype.kind == "M":
            w = w.astype("datetime64[ns]")
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w, equal_nan=w.dtype.kind == "f")


def files_frame(table):
    return table.to_pandas()


@pytest.mark.parametrize("span", [("2013-05-01", 48), ("2013-05-01", 24), ("2013-05-02", 24),
                                  ("2013-04-30", 72), ("2013-05-03", 5)])
def test_get_filenames(span, caplog):
    start, hours = span
    idx = np.datetime64(start, "ns") + np.arange(hours) * np.timedelta64(1, "h")
    caplog.clear()
    want = jsarah.get_filenames(DATA, idx)
    jax_logged = [r.getMessage() for r in caplog.records]
    caplog.clear()
    got = sarah.get_filenames(DATA, idx)
    assert [r.getMessage() for r in caplog.records] == jax_logged
    assert list(got["sis"]) == list(want["sis"]) and list(got["sid"]) == list(want["sid"])
    assert np.array_equal(np.array(got.index, dtype="datetime64[ns]"),
                          want.index.values.astype("datetime64[ns]"))
    frame = got.to_pandas()
    assert list(frame.columns) == list(want.columns) and frame.shape == want.shape


def test_get_filenames_refusals(tmp_path):
    idx = np.arange("2013-05-01T00", "2013-05-02T00", dtype="datetime64[h]")
    for mod in (jsarah, sarah):
        with pytest.raises(FileNotFoundError, match="No files found"):
            mod.get_filenames(tmp_path, idx)
    for f in DATA.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    (tmp_path / "copy").mkdir()
    name = "SISin201305010000004UD1000101UD.nc"
    (tmp_path / "copy" / name).write_bytes((DATA / name).read_bytes())
    for mod in (jsarah, sarah):
        with pytest.raises(ValueError, match="duplicate SIS files for date"):
            mod.get_filenames(tmp_path, idx)


@pytest.mark.parametrize("var", ["SIS", "SID"])
@pytest.mark.parametrize("extent", [(-4.95, -4.21, 56.05, 56.61), (-4.6, -4.4, 56.2, 56.3)])
def test_open_archive(var, extent):
    paths = sorted(str(p) for p in DATA.glob(f"{var}in*.nc"))
    same(sarah.open_archive(paths, var, extent), jsarah.open_archive(paths, var, extent))


def test_array_chain():
    rng = np.random.default_rng(0)
    v = rng.random((9, 3, 4)) * 100
    v[[0, 3, 4, 8], 1, 2] = np.nan
    v[:, 0, 0] = np.nan
    same(sarah.interpolate_nan_time(v), jsarah.interpolate_nan_time(v))
    same(sarah.hourly_mean(v), jsarah.hourly_mean(v))


def cutouts(module, **kw):
    with jax.enable_x64(False):
        jc = atlite_tpu.Cutout(None, module=module, **kw)
    return jc, atlite_tpu_torch.Cutout(module=module, device="cpu", **kw)


@pytest.mark.parametrize("interpolate", [True, False])
@pytest.mark.parametrize("lattice", ["native", "coarser"])
def test_process_sarah_from_arrays(interpolate, lattice):
    jc, tc = cutouts("sarah", x=slice(-1, 0), y=slice(50, 51), time="2013-06-01",
                     dx=0.05, dy=0.05)
    g = jc.grid_desc
    T2 = len(g.time) * 2
    rng = np.random.default_rng(0)
    times30 = np.datetime64("2013-06-01", "ns") + np.arange(T2) * np.timedelta64(30, "m")
    src_x, src_y = g.x, g.y
    if lattice == "coarser":
        jc, tc = cutouts("sarah", x=slice(-1, 0), y=slice(50, 51), time="2013-06-01",
                         dx=0.25, dy=0.25)
    sis = rng.random((T2, len(src_y), len(src_x))) * 500
    sid = sis * 0.6
    sis[3, 0, 0] = np.nan
    got = sarah.process_sarah(sis, sid, src_x, src_y, times30, tc, interpolate=interpolate)
    want = jsarah.process_sarah(sis, sid, src_x, src_y, times30, jc, interpolate=interpolate)
    same(got, want)
    arrays = {"sis": sis, "sid": sid, "x": src_x, "y": src_y, "time": times30}
    same(sarah.get_data(tc, "influx", sarah_arrays=arrays, sarah_interpolate=interpolate),
         jsarah.get_data(jc, "influx", sarah_arrays=arrays, sarah_interpolate=interpolate))


def test_process_sarah_refusals():
    jc, tc = cutouts("sarah", x=slice(-1, 0), y=slice(50, 51), time="2013-06-01",
                     dx=0.05, dy=0.05)
    g = jc.grid_desc
    times30 = np.datetime64("2013-06-01T06", "ns") + np.arange(48) * np.timedelta64(30, "m")
    sis = np.ones((48, len(g.y), len(g.x)))
    for mod, c in ((jsarah, jc), (sarah, tc)):
        with pytest.raises(ValueError, match="lacks 6 requested timestamps"):
            mod.process_sarah(sis, sis, g.x, g.y, times30, c)
        with pytest.raises(ValueError, match="sarah_dir"):
            mod.get_data(c, "influx")


def store_files(p):
    return {f.relative_to(p): hashlib.sha256(f.read_bytes()).hexdigest()
            for f in sorted(p.rglob("*")) if f.is_file()}


@pytest.mark.parametrize("case", ["native", "no_interpolation", "coarser", "with_synthetic"])
def test_prepare_from_archive(tmp_path, case):
    kw = dict(COARSE_KW if case == "coarser" else CUTOUT_KW, sarah_dir=str(DATA))
    module = ["sarah", "synthetic"] if case == "with_synthetic" else "sarah"
    if case == "no_interpolation":
        kw["sarah_interpolate"] = False
    features = ["influx", "temperature"] if case == "with_synthetic" else None
    with jax.enable_x64(False):
        jc = atlite_tpu.Cutout(tmp_path / "j", module=module, **kw).prepare(features=features)
    tc = atlite_tpu_torch.Cutout(tmp_path / "t", module=module, device="cpu",
                                 **kw).prepare(features=features)
    same({k: np.asarray(v) for k, v in tc.data.items()},
         {k: np.asarray(v) for k, v in jc.data.items()})
    assert store_files(tmp_path / "t.atc") == store_files(tmp_path / "j.atc")
    if case == "with_synthetic":
        with jax.enable_x64(False):
            want = jc.pv(panel="CSi", orientation="latitude_optimal", aggregate_time="mean")
        got = tc.pv(panel="CSi", orientation="latitude_optimal", aggregate_time="mean")
        np.testing.assert_allclose(got.values, np.asarray(want.values), rtol=1e-5, atol=2e-5)


def test_misaligned_sid_refused(monkeypatch):
    for mod, make in ((jsarah, atlite_tpu.Cutout),
                      (sarah, lambda p, **k: atlite_tpu_torch.Cutout(p, device="cpu", **k))):
        real_open = mod.open_archive

        def shifted(paths, var, extent, real_open=real_open):
            arr, lon, lat, times = real_open(paths, var, extent)
            if var == "SID":
                times = times + np.timedelta64(30, "m")
            return arr, lon, lat, times

        monkeypatch.setattr(mod, "open_archive", shifted)
        c = make(None, module="sarah", sarah_dir=str(DATA), **CUTOUT_KW)
        with pytest.raises(ValueError, match="misaligned time stamps"):
            c.prepare()


def raster_pair(seed=0):
    rng = np.random.default_rng(seed)
    data = rng.random((60, 60)) * 300
    data[:30] += 300.0
    args = (0.05, 0, -2.2, 0, -0.05, 52.2)
    return (JRaster(data, JAffine(*args), crs=4326, nodata=None),
            Raster(data, Affine(*args), crs=4326, nodata=None), data, args)


def test_gebco_height(tmp_path):
    jr, tr, data, args = raster_pair()
    jc, tc = cutouts("gebco", x=slice(-2, 0), y=slice(50, 52), time="2013-01-01")
    same(gebco.get_data(tc, "height", gebco_raster=tr),
         jgebco.get_data(jc, "height", gebco_raster=jr))
    np.savez(tmp_path / "r.npz", data=data, transform=np.array(args), crs=4326)
    same(gebco.get_data(tc, "height", gebco_path=str(tmp_path / "r.npz")),
         jgebco.get_data(jc, "height", gebco_path=str(tmp_path / "r.npz")))
    for mod, c in ((jgebco, jc), (gebco, tc)):
        with pytest.raises(ValueError, match="gebco_path"):
            mod.get_data(c, "height")
    with jax.enable_x64(False):
        jc.prepare(gebco_raster=jr)
    tc.prepare(gebco_raster=tr)
    same(tc.data["height"], np.asarray(jc.data["height"]))


def test_ncep_and_cordex():
    rng = np.random.default_rng(1)
    v = rng.random((13, 2, 3))
    for steps in (1, 3, 6):
        same(ncep.unaverage_forecast(v, steps), jncep.unaverage_forecast(v, steps))
        same(ncep.unaccumulate_forecast(v, steps), jncep.unaccumulate_forecast(v, steps))
    for port, jax_mod in ((ncep, jncep), (cordex, jcordex)):
        assert (port.crs, port.features, port.static_features) == \
            (jax_mod.crs, jax_mod.features, jax_mod.static_features)
        for mod in (port, jax_mod):
            with pytest.raises(DeprecationWarning):
                mod.get_data(None, "influx")
