"""The port's Cutout and grid against the JAX package's, on the CPU.

Held equal: the lattice and stamps of ``coordinate_range``/``Grid``
(including the inclusive end of a day label), the synthetic data that
``prepare`` stores (bit for bit, with its var_attrs), ``pack_params``,
``isel_time``.  Held close (rtol 1e-6, atol 1e-6 on values of order
<= 1e3, NaN masks identical): the device fields, the (sin, cos) pairs of
``_derive_solar_trig`` and the int16-packed reconstruction, which round
one float32 product and sum or a transcendental in either framework.
"""

import jax
import numpy as np
import pandas as pd
import pytest
import torch

import atlite_tpu
from atlite_tpu.core import grid as jgrid
from atlite_tpu_torch import Cutout
from atlite_tpu_torch.core import grid as tgrid

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
