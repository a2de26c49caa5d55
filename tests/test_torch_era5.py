"""The port's ERA5 module (``atlite_tpu_torch/datasets/era5.py``) against
the JAX package's: request chunking (``retrieval_times``), the
derivations and sanitizers, ``_open_raw`` on every file layout of the
JAX tests (the GRIB1 sample, GRIB2, classic and CF-packed NetCDF with
descending latitude, the new-CDS NETCDF4 layout written by h5py, the
ERA5/ERA5T ``expver`` layouts, a singleton ensemble axis), the merge and
alignment refusals, ``get_data`` feature by feature, and ``.atc`` stores
prepared from the same files, which must be byte for byte the JAX
package's (arrays and manifest).

Inputs come from numpy seeds and the checked-in sample file.  Every
comparison is bit for bit (the time axis as instants at ns: see
``tests/test_torch_netcdf.py``).
"""

import hashlib
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest

import atlite_tpu
import atlite_tpu_torch
from atlite_tpu.datasets import era5 as jera5
from atlite_tpu.io import grib as jgrib
from atlite_tpu.io import netcdf3 as jnetcdf3
from atlite_tpu.io.netcdf import write_netcdf as j_write_netcdf
from atlite_tpu_torch.datasets import era5

TESTS = Path(__file__).parent
SAMPLE = TESTS / "data" / "era5_sample.grib"
AREA = dict(x=slice(-4.0, 1.5), y=slice(56.0, 62.0), time="2013-01-01")


def jax_tests(name):
    """A module of the JAX package's tests, for its fixture functions."""
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", TESTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def same_arrays(got, want):
    assert list(got) == list(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if w.dtype.kind == "M":
            w = w.astype("datetime64[ns]")
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w, equal_nan=w.dtype.kind == "f"), k


def same_raw(got, want):
    (gf, gc), (wf, wc) = got, want
    same_arrays(gf, wf)
    same_arrays(gc, wc)


TIME_INDEXES = {
    "day": np.arange("2013-01-01T00", "2013-01-02T00", dtype="datetime64[h]"),
    "two_months": np.arange("2013-01-30T00", "2013-02-02T06", dtype="datetime64[h]"),
    "years": np.arange("2012-12-31T20", "2013-01-01T04", dtype="datetime64[h]"),
    "three_hourly": np.arange("2013-03-01T00", "2013-05-03T00", 3, dtype="datetime64[h]"),
    "ns_input": np.arange("2013-01-01T00", "2013-01-01T06", dtype="datetime64[h]").astype(
        "datetime64[ns]"),
}


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("monthly", [False, True])
@pytest.mark.parametrize("case", list(TIME_INDEXES))
def test_retrieval_times(case, monthly, static):
    t = TIME_INDEXES[case]
    assert era5.retrieval_times(t, static=static, monthly_requests=monthly) == \
        jera5.retrieval_times(t, static=static, monthly_requests=monthly)


def test_derivations():
    rng = np.random.default_rng(0)
    shape = (6, 4, 5)
    u100, v100, u10, v10 = (rng.normal(0, 6, shape) for _ in range(4))
    fsr = rng.normal(0.05, 0.1, shape)
    same_arrays(era5.derive_wind(u100, v100, u10, v10, fsr),
                jera5.derive_wind(u100, v100, u10, v10, fsr))
    same_arrays(era5.sanitize_wind(era5.derive_wind(u100, v100, u10, v10, fsr)),
                jera5.sanitize_wind(jera5.derive_wind(u100, v100, u10, v10, fsr)))
    ssrd = rng.random(shape) * 3e6
    ssrd[0] = 0.0
    ssr, tisr, fdir = ssrd * 0.8, ssrd * 1.3, ssrd * rng.random(shape) * 1.1 - 1e3
    times = np.arange("2013-06-01T00", "2013-06-01T06", dtype="datetime64[h]")
    lon, lat = np.linspace(-4, 0, 5), np.linspace(56, 59, 4)
    got = era5.derive_influx(ssrd, ssr, tisr, fdir, times.astype("datetime64[ns]"), lon, lat)
    want = jera5.derive_influx(ssrd, ssr, tisr, fdir, times, lon, lat)
    same_arrays(got, want)
    same_arrays(era5.sanitize_influx(dict(got)), jera5.sanitize_influx(dict(want)))
    ro = {"runoff": rng.normal(0, 1, shape)}
    same_arrays(era5.sanitize_runoff(dict(ro)), jera5.sanitize_runoff(dict(ro)))
    z = rng.random((4, 5)) * 1e4
    assert np.array_equal(era5.derive_height(z), jera5.derive_height(z))


def cf_packed_netcdf(path, fmt):
    T, NY, NX = 4, 3, 5
    rng = np.random.default_rng(0)
    t2m = rng.random((T, NY, NX)) * 30 + 270
    scale, offset = 0.001, 285.0
    packed = np.round((t2m - offset) / scale).astype(np.int16)
    packed[0, 0, 0] = -32767
    j_write_netcdf(path, {"time": T, "latitude": NY, "longitude": NX}, {
        "time": (("time",), np.arange(T, dtype="f8"), {"units": "hours since 2013-01-01"}),
        "latitude": (("latitude",), np.linspace(52, 50, NY), {}),
        "longitude": (("longitude",), np.linspace(0, 4, NX), {}),
        "t2m": (("time", "latitude", "longitude"), packed,
                {"scale_factor": scale, "add_offset": offset, "_FillValue": np.int16(-32767)}),
    }, format=fmt)


def number_netcdf(path, n):
    vals = np.arange(12 * n, dtype=np.float32).reshape(2, n, 3, 2)
    jnetcdf3.write(path, {"time": 2, "number": n, "latitude": 3, "longitude": 2}, {
        "time": (("time",), np.array([0.0, 1.0]), {"units": "hours since 2013-01-01"}),
        "latitude": (("latitude",), np.array([52.0, 51.75, 51.5]), {}),
        "longitude": (("longitude",), np.array([4.0, 4.25]), {}),
        "t2m": (("time", "number", "latitude", "longitude"), vals, {}),
    })


def raw_files(tmp_path):
    """{name: path} of every ERA5 file layout the JAX tests decode."""
    files = {"sample_grib1": SAMPLE}
    recs = jgrib.read(SAMPLE)[:40]
    (tmp_path / "g2.grib").write_bytes(jgrib.encode_grib2(recs))
    files["grib2"] = tmp_path / "g2.grib"
    for fmt in ("NETCDF3_64BIT", "NETCDF4"):
        cf_packed_netcdf(tmp_path / f"p_{fmt}.nc", fmt)
        files[f"cf_packed_{fmt}"] = tmp_path / f"p_{fmt}.nc"
    number_netcdf(tmp_path / "n1.nc", 1)
    files["number_singleton"] = tmp_path / "n1.nc"
    ev = jax_tests("test_era5_expver")
    ev._expver_netcdf(tmp_path / "ev.nc", ["t2m", "stl4", "d2m"])
    files["expver_old_layout"] = tmp_path / "ev.nc"
    (tmp_path / "ev.grib").write_bytes(jgrib.encode_grib1([
        ev._rec("t2m", "2024-05-01T00:00", 111.0, expver="0001"),
        ev._rec("t2m", "2024-05-01T00:00", 999.0, expver="0005"),
        ev._rec("t2m", "2024-05-01T01:00", 222.0, expver="0005")]))
    files["expver_grib"] = tmp_path / "ev.grib"
    return files


RAW = ["sample_grib1", "grib2", "cf_packed_NETCDF3_64BIT", "cf_packed_NETCDF4",
       "number_singleton", "expver_old_layout", "expver_grib", "new_cds_h5py"]


@pytest.mark.parametrize("case", RAW)
def test_open_raw(tmp_path, case):
    if case == "new_cds_h5py":
        path = new_cds_file(tmp_path)[0]
    else:
        path = raw_files(tmp_path)[case]
    same_raw(era5._open_raw(path), jera5._open_raw(path))


def new_cds_file(tmp_path):
    """The new-CDS layout of tests/test_era5_ingest.py: an HDF5 container
    written by h5py, valid_time, descending latitude, CF int16 fields."""
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(0)
    T, NY, NX = 24, 5, 7
    fields = {n: rng.random((T, NY, NX)) * 12 - 4 for n in ("u100", "v100", "u10", "v10")}
    fields["fsr"] = rng.random((T, NY, NX)) * 0.5 + 0.01
    fn = tmp_path / "cds_new.nc"
    with h5py.File(fn, "w") as f:
        t = f.create_dataset("valid_time", data=np.arange(T, dtype="i8"))
        t.make_scale("valid_time")
        t.attrs["units"] = "hours since 2013-06-01"
        la = f.create_dataset("latitude", data=np.linspace(58.0, 57.0, NY))
        la.make_scale("latitude")
        lo = f.create_dataset("longitude", data=np.linspace(-2.0, -0.5, NX))
        lo.make_scale("longitude")
        for name, arr in fields.items():
            scale = float(np.ptp(arr) / 60000.0) or 1e-6
            offset = float(arr.min() + 30000 * scale)
            d = f.create_dataset(name, data=np.round((arr - offset) / scale).astype("i2"),
                                 chunks=(12, NY, NX), compression="gzip")
            d.attrs["scale_factor"] = scale
            d.attrs["add_offset"] = offset
            d.attrs["_FillValue"] = np.int16(-32767)
            for i, s in enumerate((t, la, lo)):
                d.dims[i].attach_scale(s)
    return fn, dict(x=slice(-2.0, -0.5), y=slice(57.0, 58.0),
                    time=slice("2013-06-01", "2013-06-01 23:00"))


def test_open_raw_refuses_real_number_axis(tmp_path):
    number_netcdf(tmp_path / "n3.nc", 3)
    for mod in (jera5, era5):
        with pytest.raises(ValueError, match="unsupported dimension 'number'"):
            mod._open_raw(tmp_path / "n3.nc")


def test_concat_and_align_refusals():
    c0 = {"x": np.linspace(0, 4, 5), "y": np.linspace(50, 52, 3),
          "time": np.array(["2013-01-01"], dtype="datetime64[ns]")}
    c1 = dict(c0, x=np.linspace(10, 14, 5), time=np.array(["2013-01-02"], dtype="datetime64[ns]"))
    f = {"t2m": np.ones((1, 3, 5))}
    for mod in (jera5, era5):
        with pytest.raises(ValueError, match="different x lattice"):
            mod._concat_time([(f, c0), (f, c1)])
        with pytest.raises(ValueError, match="different variable sets"):
            mod._concat_time([(f, c0), ({"ssrd": np.ones((1, 3, 5))}, dict(c0))])
    c2 = dict(c0, time=np.array(["2013-01-02"], dtype="datetime64[ns]"))
    same_raw(era5._concat_time([(f, c2), ({"t2m": np.zeros((1, 3, 5))}, c0)]),
             jera5._concat_time([(f, c2), ({"t2m": np.zeros((1, 3, 5))}, c0)]))


def cutouts(path, module="era5", **kw):
    with jax.enable_x64(False):
        jc = atlite_tpu.Cutout(None if path is None else path / "j", module=module, **kw)
    tc = atlite_tpu_torch.Cutout(None if path is None else path / "t", module=module,
                                 device="cpu", **kw)
    return jc, tc


@pytest.mark.parametrize("feature", sorted(era5.features))
def test_get_data_sample(feature):
    jc, tc = cutouts(None, era5_files=str(SAMPLE), **AREA)
    got = era5.get_data(tc, feature, **tc.attrs)
    with jax.enable_x64(False):
        want = jera5.get_data(jc, feature, **jc.attrs)
    assert list(got) == list(want)
    for k in want:
        assert got[k][0] == want[k][0]
    same_arrays({k: v[1] for k, v in got.items()}, {k: v[1] for k, v in want.items()})


def test_get_data_refusals(tmp_path):
    jc, tc = cutouts(None, era5_files=str(SAMPLE), **dict(AREA, x=slice(-30, -20)))
    for mod, c in ((jera5, jc), (era5, tc)):
        with pytest.raises(ValueError, match="does not cover"):
            mod.get_data(c, "wind", **c.attrs)
        with pytest.raises(ValueError, match="unknown ERA5 feature"):
            mod.get_data(c, "snow", **c.attrs)
    jc, tc = cutouts(None, era5_files=str(SAMPLE), **dict(AREA, time="2013-01-02"))
    for mod, c in ((jera5, jc), (era5, tc)):
        with pytest.raises(ValueError, match="lacks 24 requested timestamps"):
            mod.get_data(c, "wind", **c.attrs)


def store_files(p):
    return {f.relative_to(p): hashlib.sha256(f.read_bytes()).hexdigest()
            for f in sorted(p.rglob("*")) if f.is_file()}


def prepare_both(tmp_path, features=None, **kw):
    jc, tc = cutouts(tmp_path, **kw)
    with jax.enable_x64(False):
        jc.prepare(features=features)
    tc.prepare(features=features)
    return jc, tc


@pytest.mark.parametrize("files", ["sample", "split_grib2_and_netcdf"])
def test_prepared_store_is_jax_store(tmp_path, files):
    """A store prepared from the same files, arrays and manifest byte for
    byte; ``files`` as one path, or as a list of a GRIB2 file of the first
    12 h and a NETCDF4 file of the last 12 h (concatenated on time)."""
    era5_files = str(SAMPLE)
    if files != "sample":
        recs = [r for r in jgrib.read(SAMPLE) if r["shortName"] != "z"]
        early = [r["valid_time"] < np.datetime64("2013-01-01T12:00") for r in recs]
        (tmp_path / "a.grib").write_bytes(jgrib.encode_grib2(
            [r for r, e in zip(recs, early) if e]))
        data, coords = jgrib.to_dataset([r for r, e in zip(recs, early) if not e])
        j_write_netcdf(tmp_path / "b.nc", {"time": len(coords["time"]),
                                           "latitude": len(coords["y"]),
                                           "longitude": len(coords["x"])}, {
            "time": (("time",), coords["time"], {}),
            "latitude": (("latitude",), coords["y"][::-1], {}),
            "longitude": (("longitude",), coords["x"], {}),
            **{k: (("time", "latitude", "longitude"), v[1][:, ::-1], {})
               for k, v in data.items()}}, format="NETCDF4")
        era5_files = [str(tmp_path / "a.grib"), str(tmp_path / "b.nc")]
    jc, tc = prepare_both(tmp_path, era5_files=era5_files,
                          features=None if files == "sample" else ["wind", "influx"], **AREA)
    assert store_files(tmp_path / "t.atc") == store_files(tmp_path / "j.atc")
    reopened = atlite_tpu_torch.Cutout(tmp_path / "t", device="cpu")
    assert reopened.prepared or files != "sample"


def test_prepare_resume_and_new_cds(tmp_path):
    """Feature by feature (a checkpoint each) and the new-CDS NETCDF4
    layout: stores equal; converters from the reopened stores agree."""
    prepare_both(tmp_path, features=["wind"], era5_files=str(SAMPLE), **AREA)
    jc = atlite_tpu.Cutout(tmp_path / "j")
    tc = atlite_tpu_torch.Cutout(tmp_path / "t", device="cpu")
    with jax.enable_x64(False):
        jc.prepare(features=["runoff"])
    tc.prepare(features=["runoff"])
    assert store_files(tmp_path / "t.atc") == store_files(tmp_path / "j.atc")
    fn, area = new_cds_file(tmp_path)
    (tmp_path / "n").mkdir()
    prepare_both(tmp_path / "n", features=["wind"], era5_files=str(fn), **area)
    assert store_files(tmp_path / "n" / "t.atc") == store_files(tmp_path / "n" / "j.atc")
    t = atlite_tpu_torch.Cutout(tmp_path / "n" / "t", device="cpu")
    with jax.enable_x64(False):
        want = atlite_tpu.Cutout(tmp_path / "n" / "j").wind("Vestas_V112_3MW",
                                                              aggregate_time=None)
    got = t.wind("Vestas_V112_3MW", aggregate_time=None)
    np.testing.assert_allclose(got.values, np.asarray(want.values), rtol=1e-5, atol=2e-5)
