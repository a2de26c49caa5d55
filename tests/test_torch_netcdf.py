"""The port's NetCDF layer against the JAX package's: CF time, the NetCDF-3
codec, the HDF5 (NETCDF4) reader and writer, ``write_netcdf`` and the
Cutout's NetCDF half (``Cutout("x.nc")``, ``to_netcdf``, ``to_file`` and
``prepare`` on a ``.nc`` path).

Inputs are made from numpy seeds (and by h5py and scipy where the JAX
tests use them as third-party writers).  Everything is held bit for bit:
decoded arrays with their dtypes and NaN masks, attrs, and the written
files byte for byte.  The one stated exception is CF time's unit: the
JAX package returns whatever resolution pandas picks for the inputs
(``datetime64[us]`` for whole offsets, ``[ns]`` for fractional ones) and
the port always ``datetime64[ns]``, so times are held as instants, at ns.
"""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import atlite_tpu
import atlite_tpu_torch
from atlite_tpu.io import hdf5 as jhdf5
from atlite_tpu.io import netcdf as jnetcdf
from atlite_tpu.io import netcdf3 as jnetcdf3
from atlite_tpu.io import zstd as jzstd
from atlite_tpu.io.hdf5_write import write_netcdf4 as j_write_netcdf4
from atlite_tpu_torch.io import hdf5, netcdf, netcdf3, szip, zstd
from atlite_tpu_torch.io.hdf5_write import write_netcdf4

h5py = pytest.importorskip("h5py")
from scipy.io import netcdf_file  # noqa: E402

torch.set_num_threads(1)
TESTS = Path(__file__).parent


def jax_tests(name):
    """A module of the JAX package's tests, for its fixture functions (it is
    loaded under another name, so pytest does not collect it twice)."""
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", TESTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JNC = jax_tests("test_netcdf")


def same_value(got, want):
    """Bit-for-bit equality of decoded values: arrays by dtype, shape and
    contents (NaN equal to NaN), containers item by item."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            same_value(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            same_value(g, w)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        assert got.shape == want.shape
        assert np.array_equal(got, want, equal_nan=want.dtype.kind in "fc")
    else:
        assert type(got) is type(want) and (got == want or (got != got and want != want))


# ---------------------------------------------------------------- CF time
EPOCHS = ["1900-01-01", "1900-1-1", "1900-01-01 00:00:00", "1900-01-01T00:00:00",
          "1970-01-01 00:00:00.0", "2000-01-01 12:00:00.5", "1900-01-01 00:00:00 UTC",
          "1900-01-01T00:00:00Z", "1900-01-01 00:00:00+01:00", "1900-01-01 6:00",
          "2013-1-1T3:4:5.25", "19000101", "2000-01-01 12", "1900-01-01 00:00:00.1234567891",
          "1900-01-01 00:00:00-05:30", "2001-02-30", "2000-01-01 25:00", "garbage"]
STEPS = ["seconds", "minutes", "hours", "days", "Hours", "weeks"]


def offsets():
    rng = np.random.default_rng(0)
    return [np.array([0.0, 1, 2.5]), rng.random(7) * 1000,
            np.array([1 / 3, 2 / 3, 5e-10, 2.5e-9, 3.5e-9, 0.1 + 0.2, -0.5, -1.25]),
            np.array([np.nan, 1.0]), np.array([1, 2], dtype=np.int32),
            np.array([1000000.3333]), rng.normal(0, 1e5, 11), np.array([1e300])]


def same_outcome(got_fn, want_fn, convert=lambda r: r):
    """The port's call equals the JAX call's result, or raises alike where
    it raises.  Returns whether JAX raised."""
    want, werr = outcome(want_fn)
    got, gerr = outcome(got_fn)
    if werr is not None:
        raised_alike(gerr, werr)
        return True
    assert gerr is None, gerr
    same_value(got, convert(want))
    return False


def outcome(fn, *args):
    try:
        return fn(*args), None
    except Exception as exc:  # noqa: BLE001  (the class is compared)
        return None, exc


def raised_alike(got, want):
    """The port raises where JAX raises: the same class, or the builtin
    class pandas' own exception derives from (DateParseError and
    OutOfBoundsDatetime are ValueErrors)."""
    assert got is not None, f"JAX raised {want!r}, the port did not"
    base = type(want) if type(want).__module__ == "builtins" else type(want).__mro__[1]
    assert isinstance(got, base), (got, want)


@pytest.mark.parametrize("epoch", EPOCHS)
def test_decode_cf_time(epoch):
    for step in STEPS:
        for values in offsets():
            units = f"{step} since {epoch}"
            want, werr = outcome(jnetcdf.decode_cf_time, values, units)
            got, gerr = outcome(netcdf.decode_cf_time, values, units)
            if werr is not None:
                raised_alike(gerr, werr)
                continue
            assert gerr is None, (units, gerr)
            assert got.dtype == np.dtype("datetime64[ns]")
            assert np.array_equal(got, want.astype("datetime64[ns]"), equal_nan=True), units


def test_decode_cf_time_outside_ns_range():
    """A stamp past datetime64[ns] (year 1): JAX returns datetime64[us],
    which its callers' ``astype("datetime64[ns]")`` would wrap; the port
    refuses."""
    want = jnetcdf.decode_cf_time([0.0], "hours since 0001-01-01")
    assert want.dtype == np.dtype("datetime64[us]")
    with pytest.raises(ValueError, match="datetime64\\[ns\\] range"):
        netcdf.decode_cf_time([0.0], "hours since 0001-01-01")


@pytest.mark.parametrize("calendar", [None, "standard", "GREGORIAN", "proleptic_gregorian",
                                      "360_day", "noleap", "julian"])
def test_decode_cf_time_calendars(calendar):
    want, werr = outcome(jnetcdf.decode_cf_time, [0.0, 1.5], "days since 2000-01-01", calendar)
    got, gerr = outcome(netcdf.decode_cf_time, [0.0, 1.5], "days since 2000-01-01", calendar)
    if werr is not None:
        raised_alike(gerr, werr)
    else:
        assert np.array_equal(got, want.astype("datetime64[ns]"))


@pytest.mark.parametrize("units", ["hours since 1900-01-01", "days since 2000-1-1",
                                   "seconds since 1970-01-01 00:00:00.5",
                                   "minutes since 2000-01-01T06:00",
                                   "minutes since 2000-01-01T06:00+01:00",
                                   "weeks since 2000-01-01"])
def test_encode_cf_time(units):
    t = np.array(["2013-01-01T00", "2013-01-01T01:30", "NaT", "1999-12-31T23:59:59.5"],
                 dtype="datetime64[ns]")
    want, werr = outcome(jnetcdf.encode_cf_time, t, units)
    got, gerr = outcome(netcdf.encode_cf_time, t, units)
    if werr is not None:
        raised_alike(gerr, werr)
    else:
        assert got.dtype == want.dtype and np.array_equal(got, want, equal_nan=True)


@pytest.mark.parametrize("attrs", [
    {"_FillValue": np.int16(-32767), "missing_value": np.int16(-32766), "scale_factor": 0.01,
     "add_offset": 300.0, "units": "K"},
    {"scale_factor": np.float32(0.5)}, {"add_offset": 2.0}, {"_FillValue": np.int16(-1)},
    {"units": "m"}, {"_FillValue": "bad", "scale_factor": 2.0},
], ids=["all", "scale", "offset", "fill", "none", "bad_fill"])
def test_unpack_cf(attrs):
    a = np.array([[100, -32767], [-32766, -1]], dtype=np.int16)
    same_value(netcdf.unpack_cf(a, dict(attrs)), jnetcdf.unpack_cf(a, dict(attrs)))


# ----------------------------------------------------------------- netcdf3
def netcdf3_cases():
    rng = np.random.default_rng(1)
    dims, variables, _, _ = JNC._sample_vars()
    return {
        "sample_v1": dict(dims=dims, variables=variables, attrs={"module": "era5", "n": 3},
                          record_dim="time", version=1),
        "sample_v2": dict(dims=dims, variables=variables, attrs={"module": "era5", "n": 3},
                          record_dim="time", version=2),
        "fixed_only": dict(dims=dims, variables=variables, attrs={"f": 1.5}),
        "types": dict(dims={"t": 4, "y": 3}, variables={
            "a": (("t", "y"), rng.integers(-100, 100, (4, 3)).astype("i1"), {}),
            "b": (("t", "y"), rng.integers(-1000, 1000, (4, 3)).astype("i2"), {"u": "x"}),
            "c": (("t", "y"), rng.integers(0, 10**6, (4, 3)).astype("i4"), {}),
            "d": (("t",), rng.random(4).astype("f4"), {"scale_factor": np.float32(0.5)}),
            "s": ((), np.float64(0.0), {"grid_mapping_name": "latlon"}),
        }, attrs={"list": [1, 2, 3], "fl": [0.5, 1.5]}, record_dim="t"),
        "single_record": dict(dims={"t": 5}, variables={
            "a": (("t",), np.arange(5, dtype=np.int16), {})}, record_dim="t"),
    }


@pytest.mark.parametrize("case", list(netcdf3_cases()))
def test_netcdf3_write_same_bytes(tmp_path, case):
    kw = netcdf3_cases()[case]
    jnetcdf3.write(tmp_path / "j.nc", **kw)
    netcdf3.write(tmp_path / "t.nc", **kw)
    assert (tmp_path / "t.nc").read_bytes() == (tmp_path / "j.nc").read_bytes()
    same_value(netcdf3.read(tmp_path / "j.nc"), jnetcdf3.read(tmp_path / "j.nc"))


def test_netcdf3_scipy_written(tmp_path):
    fn = tmp_path / "s.nc"
    g = netcdf_file(fn, "w")
    g.createDimension("time", None)
    g.createDimension("y", 3)
    g.history = b"made by scipy"
    g.createVariable("time", ">f8", ("time",))[:] = np.arange(7.0)
    g.createVariable("v", ">i2", ("time", "y"))[:] = np.arange(21, dtype=np.int16).reshape(7, 3)
    vf = g.createVariable("fix", ">f4", ("y",))
    vf[:] = [9, 8, 7]
    vf.units = b"m"
    g.close()
    same_value(netcdf3.read(fn), jnetcdf3.read(fn))
    same_value(netcdf3.read(fn.read_bytes()), jnetcdf3.read(fn.read_bytes()))


def test_netcdf3_shape_guard(tmp_path):
    kw = dict(dims={"t": 10, "y": 2}, variables={"v": (("t", "y"), np.ones((8, 2)), {})},
              record_dim="t")
    for write in (jnetcdf3.write, netcdf3.write):
        with pytest.raises(ValueError, match="does not match dims"):
            write(tmp_path / "bad.nc", **kw)


# -------------------------------------------------------------------- hdf5
H5_FIXTURES = {
    "v1": dict(), "v2_headers": dict(libver="latest"), "y_descending": dict(y_desc=True),
    "lat_lon": dict(coord_names=("lat", "lon")),
}


def h5py_arrays(fn):
    """{dataset name: array} as libhdf5 reads the file (an oracle
    independent of both packages)."""
    out = {}
    with h5py.File(fn, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()])
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def jax_refuses_v2_pipeline(fn):
    """The JAX reader reads a version-2 filter pipeline with version 1's
    offsets and refuses a shuffle + deflate dataset on a misread id (a
    fault of the JAX package, ROADMAP §3); the port reads it."""
    with pytest.raises(NotImplementedError, match="HDF5 filter id"):
        jhdf5.read(fn)


@pytest.mark.parametrize("case", list(H5_FIXTURES))
def test_read_h5py_cutout_files(tmp_path, case):
    """Every array as JAX's reader gives it, and where JAX refuses the
    v2 headers' pipeline, as libhdf5 gives it."""
    fn = tmp_path / "h.nc"
    JNC._h5_cutout_fixture(fn, **H5_FIXTURES[case])
    if case == "v2_headers":
        jax_refuses_v2_pipeline(fn)
        _, variables, attrs = hdf5.read_netcdf4(fn)
        oracle = h5py_arrays(fn)
        for name, (_, arr, _) in variables.items():
            assert arr.dtype == oracle[name].dtype and np.array_equal(arr, oracle[name])
        assert list(attrs["prepared_features"]) == ["wind", "influx"]
        return
    same_value(netcdf.read_netcdf(fn), _ns_times(jnetcdf.read_netcdf(fn)))
    same_value(hdf5.read_netcdf4(fn), jhdf5.read_netcdf4(fn))


def _ns_times(result):
    """A read_netcdf result with its decoded times at ns (see the module
    docstring)."""
    dims, variables, attrs = result
    variables = {k: (dn, a.astype("datetime64[ns]") if a.dtype.kind == "M" else a, va)
                 for k, (dn, a, va) in variables.items()}
    return dims, variables, attrs


def h5py_kinds(fn, rng):
    with h5py.File(fn, "w") as f:
        f.attrs["k"] = "v"
        f.attrs["ints"] = np.arange(3, dtype="i4")
        f.create_dataset("gzip_shuffle", data=rng.random((20, 7)), chunks=(6, 7),
                         compression="gzip", shuffle=True)
        f.create_dataset("contiguous", data=np.arange(9, dtype="i4"))
        f.create_dataset("u8", data=rng.integers(0, 255, (5, 5)).astype("u1"))
        f.create_dataset("i2_fill", data=rng.integers(-5, 5, (4, 6)).astype("i2"),
                         chunks=(2, 3), compression="gzip", fillvalue=-1)
        f.create_dataset("scalar", data=np.float32(2.5))
        f.create_dataset("square", data=np.ones((4, 4)))
        g = f.create_group("grp")
        g.create_dataset("inner", data=rng.random(5).astype("f4"))
        if szip.available() and h5py.h5z.filter_avail(4):
            f.create_dataset("szip_nn", data=(rng.random((64, 64)) * 1000).astype("i4"),
                             chunks=(32, 32), compression="szip")
            f.create_dataset("szip_ec", data=rng.random((40, 50)).astype("f4"),
                             chunks=(16, 25), compression="szip", compression_opts=("ec", 8))


@pytest.mark.parametrize("kind", ["v1", "v2_gzip", "v2_gzip_shuffle"])
def test_read_h5py_dataset_kinds(tmp_path, kind):
    fn = tmp_path / "k.h5"
    if kind == "v1":
        h5py_kinds(fn, np.random.default_rng(5))
    else:
        with h5py.File(fn, "w", libver="latest") as f:
            f.create_dataset("a", data=np.random.default_rng(6).random((9, 4)), chunks=(3, 4),
                             compression="gzip", shuffle=kind.endswith("shuffle"))
            f.attrs["s"] = "latest"
    if kind == "v2_gzip_shuffle":
        jax_refuses_v2_pipeline(fn)
        out, attrs, _ = hdf5.read(fn)
        assert np.array_equal(out["a"][0], h5py_arrays(fn)["a"]) and attrs["s"] == "latest"
        return
    same_value(hdf5.read(fn)[:2], jhdf5.read(fn)[:2])
    same_value(hdf5.read_netcdf4(fn), jhdf5.read_netcdf4(fn))


def writer_cases():
    rng = np.random.default_rng(0)
    T, NY, NX = 40, 7, 9
    base = {
        "time": (("time",), np.arange(T, dtype="i8"), {"units": "hours since 2013-01-01"}),
        "y": (("y",), np.linspace(50, 56, NY), {}),
        "x": (("x",), np.linspace(-3, 5, NX), {}),
        "wnd100m": (("time", "y", "x"), rng.random((T, NY, NX)).astype("f4"),
                    {"module": "era5", "feature": "wind", "pack_min": 0.5}),
        "height": (("y", "x"), rng.random((NY, NX)), {"units": "m"}),
        "scalarv": ((), np.float64(3.5), {}),
        "codes": (("time", "y", "x"), rng.integers(-30000, 30000, (T, NY, NX)).astype("i2"),
                  {"scale_factor": 0.01, "add_offset": 5.0, "_FillValue": np.int16(-32767)}),
    }
    dims = {"time": T, "y": NY, "x": NX, "extra": 3}
    attrs = {"module": "era5", "prepared_features": ["wind", "influx"], "n": 3, "f": 0.25}
    many = {"time": (("time",), np.arange(300, dtype="f8"), {})}
    many.update({f"var{i:02d}": (("time",), rng.standard_normal(300).astype("f4" if i % 2 else "f8"),
                                 {}) for i in range(14)})
    cases = {
        "default": ((dims, base, attrs), dict(chunks={"wnd100m": (16, NY, NX)})),
        "complevel9_shuffle": ((dims, base, attrs), dict(complevel=9, shuffle=True)),
        "complevel0": ((dims, base, attrs), dict(complevel=0)),
        "btree_snods": (({"time": 300}, many, {}), dict(shuffle=True,
                                                        chunks={k: (2,) for k in many})),
        "zero_length": (({"time": 0, "y": 2, "x": 2},
                         {"v": (("time", "y", "x"), np.zeros((0, 2, 2), "f4"), {})}, {}), {}),
    }
    if jzstd.available():
        cases["zstd"] = ((dims, base, attrs), dict(compression="zstd", shuffle=True,
                                                    chunks={"wnd100m": (8, NY, NX)}))
    return cases


@pytest.mark.parametrize("case", list(writer_cases()))
def test_write_netcdf4_same_bytes(tmp_path, case):
    (dims, variables, attrs), kw = writer_cases()[case]
    j_write_netcdf4(tmp_path / "j.nc", dims, variables, attrs, **kw)
    write_netcdf4(tmp_path / "t.nc", dims, variables, attrs, **kw)
    assert (tmp_path / "t.nc").read_bytes() == (tmp_path / "j.nc").read_bytes()
    same_value(hdf5.read_netcdf4(tmp_path / "t.nc"), jhdf5.read_netcdf4(tmp_path / "j.nc"))


def test_write_netcdf4_name_collision_raises(tmp_path):
    for write in (j_write_netcdf4, write_netcdf4):
        with pytest.raises(ValueError, match="collides with dimension"):
            write(tmp_path / "c.nc", {"time": 3, "y": 2, "x": 2},
                  {"time": (("y", "x"), np.ones((2, 2)), {})}, {})


def test_zstd_binding_round_trip():
    if not zstd.available():
        with pytest.raises(NotImplementedError):
            zstd.decompress(b"\x00" * 8, 8)
        assert not jzstd.available()
        return
    blob = bytes(np.random.default_rng(0).integers(0, 10, 5000).astype(np.uint8))
    assert zstd.compress(blob, 5) == jzstd.compress(blob, 5)
    assert zstd.decompress(jzstd.compress(blob, 5), len(blob)) == blob


@pytest.mark.parametrize("fmt", ["NETCDF4", "NETCDF3_64BIT"])
def test_write_netcdf_same_bytes(tmp_path, fmt):
    rng = np.random.default_rng(2)
    times = np.arange("2013-01-01T00", "2013-01-02T06", dtype="datetime64[h]").astype(
        "datetime64[ns]")
    half = times + np.timedelta64(30, "m") * (np.arange(len(times)) % 2)
    variables = {
        "time": (("time",), times, {}), "half": (("time",), half, {}),
        "flag": (("time",), rng.random(len(times)) > 0.5, {}),
        "u8": (("time",), rng.integers(0, 255, len(times)).astype("u1"), {}),
        "u16": (("time",), rng.integers(0, 60000, len(times)).astype("u2"), {}),
        "i64": (("time",), np.arange(len(times), dtype="i8"), {}),
        "big": (("time",), np.arange(len(times), dtype="i8") * 2**40, {}),
        "f16": (("time",), rng.random(len(times)).astype("f2"), {}),
    }
    dims = {"time": len(times)}
    jnetcdf.write_netcdf(tmp_path / "j.nc", dims, variables, {"a": 1}, format=fmt)
    netcdf.write_netcdf(tmp_path / "t.nc", dims, variables, {"a": 1}, format=fmt)
    assert (tmp_path / "t.nc").read_bytes() == (tmp_path / "j.nc").read_bytes()
    same_value(netcdf.read_netcdf(tmp_path / "t.nc"),
               _ns_times(jnetcdf.read_netcdf(tmp_path / "j.nc")))
    same_value(netcdf.read_netcdf(tmp_path / "t.nc", decode_times=False),
               jnetcdf.read_netcdf(tmp_path / "j.nc", decode_times=False))


def test_read_netcdf_refuses_other_files(tmp_path):
    (tmp_path / "x.nc").write_bytes(b"not a netcdf file")
    for read in (jnetcdf.read_netcdf, netcdf.read_netcdf):
        with pytest.raises(ValueError, match="not a recognized NetCDF"):
            read(tmp_path / "x.nc")


# ------------------------------------------------------------- NetCDF cutouts
SMALL = dict(module="synthetic", x=slice(-3, 0), y=slice(56, 59), time="2013-01-01")


def jax_cutout(*args, **kw):
    with jax.enable_x64(False):
        return atlite_tpu.Cutout(*args, **kw)


def same_cutout(got, want):
    """Fields, grid, attrs and var_attrs of a port Cutout equal a JAX one's."""
    g, w = got.grid_desc, want.grid_desc
    assert np.array_equal(g.x, w.x) and np.array_equal(g.y, w.y)
    assert np.array_equal(g.time, np.asarray(w.time, dtype="datetime64[ns]"))
    same_value({k: np.asarray(got.data[k]) for k in sorted(got.data)},
               {k: np.asarray(want.data[k]) for k in sorted(want.data)})
    assert got.attrs.keys() == want.attrs.keys()
    for k in want.attrs:
        assert np.array_equal(np.atleast_1d(got.attrs[k]), np.atleast_1d(want.attrs[k])), k
    assert got.var_attrs == want.var_attrs


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """The same synthetic cutout from each package, in memory."""
    with jax.enable_x64(False):
        jc = atlite_tpu.Cutout(None, **SMALL).prepare(features=["wind", "height"])
    tc = atlite_tpu_torch.Cutout(device="cpu", **SMALL).prepare(features=["wind", "height"])
    return jc, tc


@pytest.mark.parametrize("fmt", ["NETCDF4", "NETCDF3_64BIT"])
@pytest.mark.parametrize("modules", [["synthetic"], ["sarah", "synthetic"]],
                         ids=["one_module", "multi_module"])
def test_to_netcdf_same_bytes_and_cross_open(tmp_path, prepared, fmt, modules):
    jc, tc = prepared
    jc = atlite_tpu.Cutout(None, data=dict(jc.data), grid_desc=jc.grid_desc,
                           attrs={**jc.attrs, "module": modules}, var_attrs=dict(jc.var_attrs))
    tc = atlite_tpu_torch.Cutout(data=dict(tc.data), grid_desc=tc.grid_desc, device="cpu",
                                 attrs={**tc.attrs, "module": modules},
                                 var_attrs=dict(tc.var_attrs))
    jc.to_netcdf(tmp_path / "j.nc", format=fmt)
    tc.to_netcdf(tmp_path / "t.nc", format=fmt)
    assert (tmp_path / "t.nc").read_bytes() == (tmp_path / "j.nc").read_bytes()
    assert not (tmp_path / "t.nc.tmp").exists()
    # each package opens the other's file
    port = atlite_tpu_torch.Cutout(tmp_path / "j.nc", device="cpu")
    same_cutout(port, jax_cutout(tmp_path / "t.nc"))
    assert list(np.atleast_1d(port.module)) == modules


@pytest.mark.parametrize("compression", [None, {"zlib": False}, {"zlib": True, "complevel": 2}],
                         ids=["default", "no_zlib", "level2"])
def test_to_file_nc_and_compression(tmp_path, prepared, compression):
    jc, tc = prepared
    jc.to_netcdf(tmp_path / "j.nc", compression=compression)
    tc.to_netcdf(tmp_path / "t.nc", compression=compression)
    assert (tmp_path / "t.nc").read_bytes() == (tmp_path / "j.nc").read_bytes()
    tc.to_file(tmp_path / "f.nc")
    jc.to_file(tmp_path / "g.nc")
    assert (tmp_path / "f.nc").read_bytes() == (tmp_path / "g.nc").read_bytes()


@pytest.mark.parametrize("case", list(H5_FIXTURES))
def test_open_h5py_cutout(tmp_path, case):
    """atlite-style NETCDF4 cutouts written by libhdf5 (dimension scales,
    vlen-string lists, descending latitude, lon/lat names)."""
    fn = tmp_path / "ref.nc"
    JNC._h5_cutout_fixture(fn, **H5_FIXTURES[case])
    port = atlite_tpu_torch.Cutout(fn, device="cpu")
    if case == "v2_headers":
        # JAX refuses the file; the same fixture with v1 headers is its twin
        jax_refuses_v2_pipeline(fn)
        fn = tmp_path / "twin.nc"
        JNC._h5_cutout_fixture(fn)
    same_cutout(port, jax_cutout(fn))
    assert port.grid_desc.y[0] < port.grid_desc.y[-1]
    out = port.wind(turbine="Vestas_V112_3MW", aggregate_time=None)
    with jax.enable_x64(False):
        want = jax_cutout(fn).wind(turbine="Vestas_V112_3MW", aggregate_time=None)
    np.testing.assert_allclose(out.values, np.asarray(want.values), rtol=1e-5, atol=2e-5)


def test_open_descending_lon_lat_packed(tmp_path):
    """Both axes descending, lon/lat names and CF int16 packing: the port
    flips and unpacks as JAX does."""
    rng = np.random.default_rng(3)
    T, NY, NX = 5, 4, 6
    wnd = rng.random((T, NY, NX)) * 20
    scale, offset = 20 / 60000, 10.0
    codes = np.round((wnd - offset) / scale).astype("i2")
    codes[0, 0, 0] = -32767
    variables = {
        "time": (("time",), np.arange(T, dtype="f8"), {"units": "hours since 2013-01-01"}),
        "lat": (("lat",), np.linspace(59, 56, NY), {}),
        "lon": (("lon",), np.linspace(0, -3, NX), {}),
        "wnd100m": (("time", "lat", "lon"), codes,
                    {"scale_factor": scale, "add_offset": offset, "_FillValue": np.int16(-32767)}),
    }
    attrs = {"module": "synthetic", "prepared_features": "wind"}
    for fmt in ("NETCDF4", "NETCDF3_64BIT"):
        fn = tmp_path / f"d_{fmt}.nc"
        jnetcdf.write_netcdf(fn, {"time": T, "lat": NY, "lon": NX}, variables, attrs, format=fmt)
        port = atlite_tpu_torch.Cutout(fn, device="cpu")
        same_cutout(port, jax_cutout(fn))
        assert np.isnan(port.data["wnd100m"][0, -1, -1])


def test_prepare_writes_nc_cutout(tmp_path):
    """prepare on a .nc path writes the file whole once per call; a second
    prepare resumes; the file equals JAX's byte for byte after each."""
    jc = jax_cutout(tmp_path / "j.nc", **SMALL)
    tc = atlite_tpu_torch.Cutout(tmp_path / "t.nc", device="cpu", **SMALL)
    with jax.enable_x64(False):
        jc.prepare(features=["wind"])
    tc.prepare(features=["wind"])
    assert (tmp_path / "t.nc").read_bytes() == (tmp_path / "j.nc").read_bytes()
    reopened = atlite_tpu_torch.Cutout(tmp_path / "t.nc", device="cpu")
    assert {f for _, f in reopened.prepared_features.index} == {"wind"}
    reopened.prepare()
    with jax.enable_x64(False):
        jax_cutout(tmp_path / "j.nc").prepare()
    assert (tmp_path / "t.nc").read_bytes() == (tmp_path / "j.nc").read_bytes()
    assert atlite_tpu_torch.Cutout(tmp_path / "t.nc", device="cpu").prepared


def test_nc_cutout_streams_and_shards(tmp_path, prepared):
    """A cutout loaded from NetCDF (host arrays, not memory maps) streams
    in packed chunks and shards over a mesh as a store does."""
    from atlite_tpu_torch.core.mesh import make_mesh

    _, tc = prepared
    tc.to_netcdf(tmp_path / "c.nc")
    nc = atlite_tpu_torch.Cutout(tmp_path / "c.nc", device="cpu")
    m = np.random.default_rng(0).random((3, nc.shape[0] * nc.shape[1])).astype(np.float32)
    for kw in (dict(), dict(time_chunk=10), dict(time_chunk=10, stream_pack="int16")):
        got = nc.wind("Vestas_V112_3MW", matrix=m, aggregate_time=None, **kw).values
        assert np.array_equal(got, tc.wind("Vestas_V112_3MW", matrix=m, aggregate_time=None,
                                           **kw).values), kw
    want = tc.wind("Vestas_V112_3MW", matrix=m, aggregate_time=None).values
    nc.shard(make_mesh([torch.device("cpu")] * 4))
    sh = nc.wind("Vestas_V112_3MW", matrix=m, aggregate_time=None).values
    nc.unshard()
    np.testing.assert_allclose(sh, want, rtol=1e-5, atol=1e-4)
