"""The port's ``data.py``, ``utils.py`` and CDS client against the JAX
package's: ``available_features`` (the port's Table, whose
``to_pandas()`` equals JAX's Series), ``get_features``,
``cutout_prepare``, ``non_bool_dict``, ``maybe_remove_tmpdir``,
``ensure_coords`` (pandas indexes read by their attributes; a mapping's
values as numpy arrays where JAX makes pandas Indexes: compared by
values), ``timeindex_from_slice`` (``datetime64[ns]`` stamps equal to
JAX's DatetimeIndex), ``CachedAttribute``, ``maybe_tqdm``, the
``arrowdict`` re-export, ``migrate_from_cutout_directory`` on the
fixture of ``tests/test_netcdf.py`` (the migrated file byte for byte
JAX's), and the CDS client against the local HTTP mock of
``tests/test_cds.py`` (submit, poll, download; terminal failures;
credentials; the file lock; request fan-out).  Nothing reaches the
network: the mock listens on localhost.

Bit for bit everywhere (float fields compared with NaN equal to NaN).
"""

import importlib.util
import threading
from http.server import HTTPServer
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest

import atlite_tpu
import atlite_tpu_torch
from atlite_tpu import data as jdata
from atlite_tpu import utils as jutils
from atlite_tpu.core.grid import Grid as JGrid
from atlite_tpu.io import cds as jcds
from atlite_tpu_torch import data, utils
from atlite_tpu_torch.core.grid import Grid
from atlite_tpu_torch.io import cds

TESTS = Path(__file__).parent


def jax_tests(name):
    """A module of the JAX package's tests, for its fixtures."""
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", TESTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("module", [None, "era5", ["era5", "sarah"], "gebco", "synthetic",
                                    "ncep"])
def test_available_features(module):
    got = data.available_features(module)
    want = jdata.available_features(module)
    pd.testing.assert_series_equal(got.to_pandas(), want)
    assert list(got.values) == list(want.values)


def test_non_bool_dict_and_tmpdir(tmp_path):
    d = {"a": True, "b": False, "c": 1.5, "d": "x", "e": np.int64(3)}
    got, want = data.non_bool_dict(d), jdata.non_bool_dict(d)
    assert got == want and [type(v) for v in got.values()] == [type(v) for v in want.values()]
    for wrap in (data.maybe_remove_tmpdir, jdata.maybe_remove_tmpdir):
        seen = {}

        @wrap
        def fn(tmpdir=None):
            seen["dir"] = tmpdir
            (Path(tmpdir) / "scratch").write_text("x")
            return 7

        assert fn() == 7 and not Path(seen["dir"]).exists()
        keep = tmp_path / "keep"
        keep.mkdir(exist_ok=True)
        assert fn(tmpdir=str(keep)) == 7 and keep.exists()


SMALL = dict(module="synthetic", x=slice(-3, 0), y=slice(56, 59), time="2013-01-01")


def test_get_features_and_cutout_prepare(tmp_path):
    with jax.enable_x64(False):
        jc = atlite_tpu.Cutout(None, **SMALL)
        want = jdata.get_features(jc, "synthetic", ["wind", "height"])
    tc = atlite_tpu_torch.Cutout(device="cpu", **SMALL)
    got = data.get_features(tc, "synthetic", ["wind", "height"])
    assert list(got) == list(want)
    for k in want:
        assert got[k][0] == want[k][0]
        assert np.array_equal(got[k][1], np.asarray(want[k][1]), equal_nan=True)
    with jax.enable_x64(False):
        jdata.cutout_prepare(jc, features=["wind"])
    assert data.cutout_prepare(tc, features=["wind"]) is tc
    assert sorted(tc.data) == sorted(jc.data)
    for k in jc.data:
        assert np.array_equal(tc.data[k], np.asarray(jc.data[k]))


def test_ensure_coords():
    idx = pd.Index([1, 2, 3], name="bus")
    mi = pd.MultiIndex.from_tuples([(1, "a"), (2, "b")])
    mi.name = "cell"
    for arg in (idx, pd.Index([1, 2]), mi, {"x": [0.0, 1.0], "y": np.arange(3)}):
        got, want = utils.ensure_coords(arg), jutils.ensure_coords(arg)
        assert list(got) == list(want)
        for k in want:
            assert list(got[k]) == list(want[k])
            if not isinstance(arg, dict):
                assert got[k] is arg
    for mod in (utils, jutils):
        with pytest.raises(ValueError, match="pandas index or a coords mapping"):
            mod.ensure_coords(42)


@pytest.mark.parametrize("sl", [("2013-01", "2013-02"), ("2013-01-01", "2013-01-31"),
                                ("2012-12", "2012-12"), ("2013-01-31", "2013-01-31"),
                                ("2012-01-15 06:00", "2012-01-31 13:30"), ("2013", "2013-03"),
                                ("2011-1-5", "2011-2-28"), ("2012-02-29", "2012-03-31")])
def test_timeindex_from_slice(sl):
    got = utils.timeindex_from_slice(slice(*sl))
    want = jutils.timeindex_from_slice(slice(*sl))
    assert got.dtype == np.dtype("datetime64[ns]")
    assert np.array_equal(got, want.values.astype("datetime64[ns]"))


def test_cached_attribute_tqdm_arrowdict():
    calls = []
    for mod in (utils, jutils):
        class C:
            @mod.CachedAttribute
            def value(self):
                """The doc."""
                calls.append(1)
                return 42

        c = C()
        assert (c.value, c.value) == (42, 42) and C.value.__doc__ == "The doc."
    assert len(calls) == 2
    items = [1, 2, 3]
    assert utils.maybe_tqdm(items, enable=False) is items
    assert list(utils.maybe_tqdm(items, disable=True)) == list(jutils.maybe_tqdm(items,
                                                                                 disable=True))
    assert utils.arrowdict is atlite_tpu_torch.resource.arrowdict
    assert utils.arrowdict(a=1).a == jutils.arrowdict(a=1).a == 1


def old_cutout_directory(old):
    """The legacy layout of tests/test_netcdf.py: meta.nc and one file a
    month, written by the JAX package."""
    old.mkdir()
    with jax.enable_x64(False):
        base = atlite_tpu.Cutout(None, module="synthetic", x=slice(-3, 0), y=slice(56, 59),
                                 time=slice("2013-01", "2013-02")).prepare(features=["wind"])
    jan = base.grid_desc.time_index.month == 1
    atlite_tpu.Cutout(data={}, grid_desc=base.grid_desc, attrs={"module": "synthetic"},
                      var_attrs={}).to_netcdf(old / "meta.nc")
    for sel, name in ((jan, "201301.nc"), (~jan, "201302.nc")):
        atlite_tpu.Cutout(
            data={k: np.asarray(v)[sel] for k, v in base.data.items()},
            grid_desc=JGrid(x=base.grid_desc.x, y=base.grid_desc.y,
                            time=base.grid_desc.time[sel], crs=4326),
            attrs={"module": "synthetic"}, var_attrs=base.var_attrs,
        ).to_netcdf(old / name)
    return base


def test_migrate_from_cutout_directory(tmp_path):
    base = old_cutout_directory(tmp_path / "old")
    want = jutils.migrate_from_cutout_directory(tmp_path / "old", tmp_path / "j")
    got = utils.migrate_from_cutout_directory(tmp_path / "old", tmp_path / "t", device="cpu")
    assert (tmp_path / "t.nc").read_bytes() == (tmp_path / "j.nc").read_bytes()
    assert isinstance(got, atlite_tpu_torch.Cutout) and got.device.type == "cpu"
    assert len(got.grid_desc.time) == len(base.grid_desc.time)
    for k in want.data:
        assert np.array_equal(got.data[k], np.asarray(want.data[k]), equal_nan=True)
    assert got.attrs.keys() == want.attrs.keys() and got.var_attrs == want.var_attrs
    for mod in (utils, jutils):
        with pytest.raises(FileNotFoundError, match="no monthly"):
            (tmp_path / "empty").mkdir(exist_ok=True)
            atlite_tpu_torch.Cutout(data={}, grid_desc=Grid(
                x=base.grid_desc.x, y=base.grid_desc.y, time=base.grid_desc.time, crs=4326),
                attrs={"module": "synthetic"}, device="cpu").to_netcdf(
                    tmp_path / "empty" / "meta.nc")
            mod.migrate_from_cutout_directory(tmp_path / "empty", tmp_path / "x")


# ------------------------------------------------------------------ CDS
CDS_TESTS = jax_tests("test_cds")


@pytest.fixture()
def mock_cds():
    srv = HTTPServer(("localhost", 0), CDS_TESTS._Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://localhost:{srv.server_address[1]}"
    srv.shutdown()
    t.join(timeout=5)


def test_cds_retrieve(mock_cds, tmp_path):
    pytest.importorskip("requests")
    CDS_TESTS._Handler.state["fail_as"] = None
    for mod, name in ((cds, "t.grib"), (jcds, "j.grib")):
        c = mod.Client(url=mock_cds, key="test-key", sleep=0.01)
        assert c.retrieve("reanalysis-era5-single-levels", {"variable": ["t2m"]},
                          tmp_path / name) == tmp_path / name
    assert (tmp_path / "t.grib").read_bytes() == (tmp_path / "j.grib").read_bytes() \
        == CDS_TESTS.PAYLOAD
    assert not (tmp_path / "t.grib.part").exists()


@pytest.mark.parametrize("state", ["failed", "dismissed", "rejected"])
def test_cds_terminal_failures(mock_cds, tmp_path, state):
    pytest.importorskip("requests")
    CDS_TESTS._Handler.state["fail_as"] = state
    c = cds.Client(url=mock_cds, key="test-key", sleep=0.01)
    with pytest.raises(RuntimeError, match=state):
        c.retrieve("reanalysis-era5-single-levels", {"variable": ["t2m"]}, tmp_path / "x.grib")
    assert not (tmp_path / "x.grib").exists()
    CDS_TESTS._Handler.state["fail_as"] = None


def test_cds_credentials_lock_and_fan_out(tmp_path, monkeypatch):
    monkeypatch.delenv("CDSAPI_URL", raising=False)
    monkeypatch.delenv("CDSAPI_KEY", raising=False)
    rc = tmp_path / "cdsapirc"
    rc.write_text("url: https://example.org/api\nkey: abc:123\n")
    monkeypatch.setenv("CDSAPI_RC", str(rc))
    assert cds.read_credentials() == jcds.read_credentials() == ("https://example.org/api",
                                                                 "abc:123")
    monkeypatch.setenv("CDSAPI_KEY", "envkey")
    assert cds.read_credentials() == jcds.read_credentials()
    monkeypatch.setenv("CDSAPI_RC", str(tmp_path / "missing"))
    monkeypatch.delenv("CDSAPI_KEY")
    for mod in (cds, jcds):
        with pytest.raises(RuntimeError, match="No CDS credentials"):
            mod.read_credentials()
    out, errors = tmp_path / "shared.bin", []

    def writer(i):
        try:
            with cds.file_lock(out):
                with open(out, "wb") as fh:
                    for _ in range(16):
                        fh.write(bytes([i]) * 4096)
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(set(out.read_bytes())) == 1
    for concurrent in (False, True):
        assert cds.map_requests(lambda r: r * 2, [1, 2, 3], concurrent=concurrent,
                                max_workers=2) == \
            jcds.map_requests(lambda r: r * 2, [1, 2, 3], concurrent=concurrent, max_workers=2)
