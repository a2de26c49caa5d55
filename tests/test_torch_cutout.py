"""The port's Cutout and grid against the JAX package's, on the CPU.

Held equal: the lattice and stamps of ``coordinate_range``/``Grid``
(including the inclusive end of a day label), the synthetic data that
``prepare`` stores (bit for bit, with its var_attrs), ``pack_params``,
``isel_time``.  Held close (rtol 1e-6, atol 1e-6 on values of order
<= 1e3, NaN masks identical): the device fields, the (sin, cos) pairs of
``_derive_solar_trig`` and the int16-packed reconstruction, which round
one float32 product and sum or a transcendental in either framework.
Held bit for bit against every variable staged up front: what
``fields()`` stages on a first read (names alone stage nothing), with
the counters ``Cutout.staged_variables`` and ``staged_bytes``.
"""

import sys
import threading
import warnings

import jax
import numpy as np
import pandas as pd
import pytest
import torch

import atlite_tpu
from atlite_tpu.core import grid as jgrid
from atlite_tpu_torch import Cutout
from atlite_tpu_torch.core import grid as tgrid
from atlite_tpu_torch.cutout import _derive_solar_trig
from atlite_tpu_torch.ops.megakernel import FIELD_ORDER

torch.set_num_threads(1)

KW = dict(module="synthetic", x=slice(-4, 1.5), y=slice(56, 62),
          time=slice("2013-01-01", "2013-01-03"))
FEATURES = ["wind", "influx", "temperature", "height", "runoff"]


@pytest.fixture(scope="module")
def pair():
    """(JAX cutout, port cutout), prepared alike."""
    with jax.enable_x64(False):
        jc = atlite_tpu.Cutout(None, **KW).prepare(features=FEATURES)
    tc = Cutout(device="cpu", **KW).prepare(features=FEATURES)
    return jc, tc


def close(got, want, rtol=1e-6, atol=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("time", [
    slice("2013-01-01", "2013-01-02"), "2013-12-31", "2013-02", ("2012-12-31", "2013-01-01"),
    slice("2013-1-5", "2013-1-6"), slice("2013-06-01 05:00", "2013-06-01 17:00"),
    slice(None, "1940-01-02")])
def test_coordinate_range_equals_jax(time):
    args = (slice(-12, 18.03125), slice(35, 60.05), time, 30 / 480, 25 / 240)
    xs, ys, ts = tgrid.coordinate_range(*args)
    xj, yj, tj = jgrid.coordinate_range(*args)
    np.testing.assert_array_equal(xs, xj)
    np.testing.assert_array_equal(ys, yj)
    assert ts.dtype == np.dtype("datetime64[ns]")
    np.testing.assert_array_equal(ts, np.asarray(tj, dtype="datetime64[ns]"))


def test_day_label_runs_to_its_last_hour():
    _, _, ts = tgrid.coordinate_range((0, 1), (0, 1), slice("2013-12-30", "2013-12-31"))
    assert len(ts) == 48 and ts[-1] == np.datetime64("2013-12-31T23:00", "ns")
    for label in ("2011", "2011-1", "2011-1-5", "2013-02", "2013-01-01 12:00"):
        # the JAX package's pandas may keep microseconds: equal to within one
        gap = tgrid._end_of(label) - pd.Timestamp(jgrid._end_of(label)).to_datetime64()
        assert np.timedelta64(0, "ns") <= gap < np.timedelta64(1, "us"), label


def test_grid_equals_jax(pair):
    jc, tc = pair
    g, j = tc.grid_desc, jc.grid_desc
    assert g.shape == j.shape and g.ncells == j.ncells
    assert (g.dx, g.dy) == (j.dx, j.dy)
    np.testing.assert_array_equal(g.time_index, j.time_index.values)
    assert len(g.time) == 72  # the last day runs to 23:00


def test_prepare_equals_jax(pair):
    jc, tc = pair
    assert sorted(tc.data) == sorted(jc.data)
    for k in jc.data:
        assert tc.data[k].dtype == jc.data[k].dtype, k
        np.testing.assert_array_equal(tc.data[k], jc.data[k], err_msg=k)
        assert tc.var_attrs[k] == jc.var_attrs[k], k
    assert tc.attrs["prepared_features"] == jc.attrs["prepared_features"]


def test_dataset_module_contract_equals_jax():
    from atlite_tpu.datasets import modules as jmodules
    from atlite_tpu_torch.datasets import modules

    assert sorted(modules) == sorted(jmodules) == ["era5", "gebco", "sarah", "synthetic"]
    for name, j in jmodules.items():
        t = modules[name]
        assert (t.crs, t.features, t.static_features) == (j.crs, j.features, j.static_features)


def test_prepare_keeps_prepared_and_overwrites():
    tc = Cutout(device="cpu", **KW).prepare(features="wind")
    before = tc.data["wnd100m"]
    tc.prepare(features="wind")
    assert tc.data["wnd100m"] is before
    tc.prepare(features="wind", overwrite=True)
    assert tc.data["wnd100m"] is not before
    np.testing.assert_array_equal(tc.data["wnd100m"], before)


def test_pack_params_equal_jax(pair):
    jc, tc = pair
    names = list(jc.data) + ["height"]
    got, want = tc.pack_params(names), jc.pack_params(names)
    assert got == want
    assert "height" not in got  # static: staged raw


def test_fields_equal_jax(pair):
    jc, tc = pair
    with jax.enable_x64(False):
        want = {k: np.asarray(v) for k, v in jc.fields().items()}
    got = tc.fields()
    assert set(got) == set(want)
    for k in want:
        assert got[k].device.type == "cpu"
        close(got[k].numpy(), want[k])
    for k in ("solar_altitude_sin", "solar_altitude_cos", "solar_azimuth_sin",
              "solar_azimuth_cos"):
        assert k in got
    assert tc.fields() is got  # built once


@pytest.mark.parametrize("only", [None, {"wnd100m", "roughness", "solar_altitude", "height"}])
def test_isel_time_equals_jax(pair, only):
    jc, tc = pair
    sub, jsub = tc.isel_time(10, 40, only=only), jc.isel_time(10, 40, only=only)
    assert set(sub.data) == set(jsub.data)
    np.testing.assert_array_equal(sub.grid_desc.time, jsub.grid_desc.time)
    for k in jsub.data:
        np.testing.assert_array_equal(sub.data[k], jsub.data[k])
    assert np.shares_memory(sub.data["wnd100m"], tc.data["wnd100m"])  # a view
    assert sub.device == tc.device
    with jax.enable_x64(False):
        want = {k: np.asarray(v) for k, v in jsub.fields().items()}
    got = sub.fields()
    assert set(got) == set(want)
    for k in want:
        close(got[k].numpy(), want[k])
    assert got["height"] is tc._stage_static()["height"]  # the parent's static


def test_packed_fields_equal_jax():
    kw = {**KW, "time": "2013-01-01"}
    with jax.enable_x64(False):
        jc = atlite_tpu.Cutout(None, **kw).prepare(features=["wind", "influx", "temperature"])
    tc = Cutout(device="cpu", **kw).prepare(features=["wind", "influx", "temperature"])
    names = ["influx_direct", "roughness", "temperature", "solar_altitude"]
    for c in (jc, tc):
        # a NaN cell-hour exercises the 65535 sentinel; a roughness over
        # more than three decades packs in log space
        c.data["influx_direct"][12, 3, 4] = np.nan
        c.data["roughness"][:, 0, 0] = 1e-5
        c.var_attrs["roughness"]["pack_min"] = 1e-5
    assert tc.pack_params(names) == jc.pack_params(names)
    assert tc.pack_params(names)["roughness"][2]
    with jax.enable_x64(False):
        jsub = jc.isel_time(5, 29, only=set(names), pack16=jc.pack_params(names))
        want = {k: np.asarray(v) for k, v in jsub.fields().items()}
    sub = tc.isel_time(5, 29, only=set(names), pack16=tc.pack_params(names))
    batch = sub._pack(sub.dtype)
    assert batch["host"].dtype == torch.int16 and batch["params"] is not None
    codes = batch["host"].numpy().view(np.uint16)
    i = batch["names"].index("influx_direct")
    assert codes[i, 7, 3, 4] == 65535 and (codes[i] != 65535).sum() == codes[i].size - 1
    got = sub.fields()
    assert bool(torch.isnan(got["influx_direct"][7, 3, 4]))
    for k in names + ["solar_altitude_sin", "solar_altitude_cos"]:
        close(got[k].numpy(), want[k], rtol=1e-6, atol=1e-5)
    # log-space packing keeps roughness within 2e-4 relative of the raw values
    raw = tc.data["roughness"][5:29]
    np.testing.assert_allclose(got["roughness"].numpy(), raw, rtol=2e-4)


def test_cutout_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Cutout(**KW)
    with pytest.raises(TypeError, match="must be specified"):
        Cutout("europe.nc", device="cpu")  # no NetCDF file there, nor the arguments
    with pytest.raises(TypeError, match="must be specified"):
        Cutout("europe.atc", device="cpu")  # no store there, nor the arguments to make one
    with pytest.raises(ValueError, match="unknown dataset"):
        Cutout(device="cpu", **{**KW, "module": "ncep"})  # outside the registry, as in JAX
    with pytest.raises(TypeError, match="grid_desc"):
        Cutout(device="cpu", data={})


# ---------------------------------------------------------------- staging
def fresh(tc):
    """A cutout over ``tc``'s host arrays with nothing staged."""
    return Cutout(data=tc.data, grid_desc=tc.grid_desc, attrs=dict(tc.attrs),
                  var_attrs=dict(tc.var_attrs), device="cpu")


def eager_fields(c, dtype=None):
    """Every variable staged up front: ``_put`` each, then the (sin, cos)
    pairs of ``_derive_solar_trig``."""
    dtype = c.dtype if dtype is None else np.dtype(dtype)
    cache = {n: c._put(a, dtype) for n, a in c.data.items()}
    _derive_solar_trig(cache)
    return cache


def counters():
    return Cutout.staged_variables, Cutout.staged_bytes


def assert_bits(got, want):
    """Equal tensors, bit for bit (NaN included)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.numpy().tobytes() == want.numpy().tobytes()


def test_fields_name_everything_and_stage_nothing(pair):
    c = fresh(pair[1])
    want = eager_fields(c)
    before = counters()
    f = c.fields()
    assert list(f) == list(want) and list(f.keys()) == list(want) and len(f) == len(want)
    assert f.keys() == want.keys() and set(f) == set(want)
    assert all(k in f for k in want) and "nope" not in f and f.get("nope") is None
    assert list(reversed(f)) == list(reversed(want))
    assert counters() == before and dict.__len__(f) == 0  # names alone stage nothing
    assert c.fields() is f  # built once


TRIG = ("solar_altitude_sin", "solar_altitude_cos", "solar_azimuth_sin", "solar_azimuth_cos")


@pytest.mark.parametrize("read, staged", [
    (lambda f: [f[k] for k in FIELD_ORDER], set(FIELD_ORDER)),
    (lambda f: f["solar_altitude_cos"], {"solar_altitude", *TRIG[:2]}),
    (lambda f: f["solar_azimuth_sin"], {"solar_azimuth", *TRIG[2:]}),
    (lambda f: [f.get(k) for k in ("wnd100m", "nope")], {"wnd100m"}),
    (lambda f: dict(f.items()), None),
    (lambda f: list(f.values()), None),
    (lambda f: {**f}, None),
    (lambda f: f.copy(), None),
], ids=["step", "altitude_cos", "azimuth_sin", "get", "items", "values", "unpack", "copy"])
def test_a_first_read_stages_what_it_reads(pair, read, staged):
    """Reading stages exactly the names read (a (sin, cos) name: its
    angle and both of its pair), bit for bit as staged up front, and the
    counters count them; whole-mapping reads stage everything."""
    c = fresh(pair[1])
    want = eager_fields(c)
    staged = set(want) if staged is None else staged
    f = c.fields()
    v0, b0 = counters()
    read(f)
    assert set(dict.keys(f)) == staged
    assert Cutout.staged_variables - v0 == len(staged)
    assert Cutout.staged_bytes - b0 == sum(want[k].numel() * want[k].element_size()
                                           for k in staged)
    for k in staged:
        assert_bits(f[k], want[k])
    assert list(f) == list(want)  # the names, in the order staged up front


def test_a_second_read_stages_nothing(pair):
    f = fresh(pair[1]).fields()
    first = f["solar_azimuth_cos"]
    before = counters()
    assert f["solar_azimuth_cos"] is first and f["solar_azimuth_sin"] is f["solar_azimuth_sin"]
    assert f["solar_azimuth"] is f["solar_azimuth"]
    assert counters() == before


def test_written_fields_are_kept(pair):
    c = fresh(pair[1])
    f = c.fields()
    t = torch.zeros(3)
    f["extra"] = t
    f["solar_altitude_sin"] = t
    assert f["extra"] is t and "extra" in f and list(f)[-1] == "extra"
    f["solar_altitude_cos"]  # derives the pair, and keeps the written sin
    assert f["solar_altitude_sin"] is t
    assert_bits(f["solar_altitude_cos"], eager_fields(c)["solar_altitude_cos"])
    assert f.pop("extra") is t and "extra" not in f and len(f) == len(eager_fields(c))
    f |= {"extra": t}
    assert f["extra"] is t


@pytest.mark.parametrize("how", ["invalidate", "prepare"])
def test_a_new_mapping_after_prepare_or_invalidate(how):
    """The mapping keeps the host arrays of the moment it was built; after
    ``_invalidate()`` or ``prepare()`` the cutout builds a fresh one."""
    c = Cutout(device="cpu", **{**KW, "time": "2013-01-01"}).prepare(features="wind")
    f = c.fields()
    old = c.data["wnd100m"]
    if how == "invalidate":
        c._invalidate()
    else:
        c.prepare(features=["wind", "temperature"], overwrite=True)
        assert c.data["wnd100m"] is not old
    g = c.fields()
    assert g is not f and dict.__len__(g) == 0
    assert ("temperature" in g) == (how == "prepare") and "temperature" not in f
    # a float32 array is staged on the CPU without a copy: each mapping
    # holds its own moment's array
    assert np.shares_memory(f["wnd100m"].numpy(), old)
    assert np.shares_memory(g["wnd100m"].numpy(), c.data["wnd100m"])


def test_float64_fields_get_their_own_mapping(pair):
    c = fresh(pair[1])
    f32 = c.fields()
    f64 = c.fields("float64")
    assert f64 is not f32 and c.fields("float64") is f64 and dict.__len__(f64) == 0
    want = eager_fields(c, "float64")
    assert list(f64) == list(want)
    for k in ("wnd100m", "solar_altitude_cos", "height"):
        assert f64[k].dtype == torch.float64
        assert_bits(f64[k], want[k])


def test_readonly_store_fields_are_cpu_copies(pair, tmp_path):
    """A reopened store's memory maps stay on ``_put``'s path: each staged
    tensor is a writable copy of its own on the CPU."""
    tc = pair[1]
    Cutout(tmp_path / "s", data=tc.data, grid_desc=tc.grid_desc, attrs=dict(tc.attrs),
           var_attrs=dict(tc.var_attrs), device="cpu").to_file()
    c = Cutout(tmp_path / "s", device="cpu")
    assert not c.data["wnd100m"].flags.writeable
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        f = c.fields()
        t = f["wnd100m"]
    a = t.numpy()
    assert a.flags.writeable and not np.shares_memory(a, c.data["wnd100m"])
    np.testing.assert_array_equal(a, tc.data["wnd100m"])
    assert dict.__len__(f) == 1


def test_threads_stage_each_name_once(pair):
    """Threads that read the same names at once stage each one once and
    all get the same tensors."""
    c = fresh(pair[1])
    f = c.fields()
    names = list(f)
    got, errors = [], []
    start = threading.Barrier(12)

    def read():
        try:
            start.wait(timeout=30)
            got.append([f[k] for k in names[::-1]])
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    v0 = Cutout.staged_variables
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=read) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors and len(got) == 12
    assert Cutout.staged_variables - v0 == len(names)
    assert all(a is b for row in got for a, b in zip(row, got[0]))
