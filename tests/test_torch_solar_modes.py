"""Tracking modes, Hay-Davies, irradiation and solar thermal: the port
against the JAX package on the same synthetic cutouts, on the CPU, JAX
with x64 off.

Covered: ``surface_orientation`` for every tracking mode and four
orientations, north and south; ``irradiation`` for all four kinds under
both transposition models; ``pv`` under every tracking mode and both
models, resident, with a matrix and streamed; ``solar_thermal`` with its
default and other collectors; an ``"influx"`` cutout (ERA5 style) with
humidity, under the simple, enhanced and automatic clearsky models,
resident and streamed.

Tolerance: 1e-5 * max|JAX| in absolute terms, NaN masks identical.  One
known float32 behaviour is bounded apart: the tilted single-axis
tracker's surface slope is ``arccos(cos(rotation) * cos(tilt))``, and at
a tilt of 0 the argument sits next to 1, where XLA's and PyTorch's
float32 ``arccos``/``cos`` differ by an ulp of the argument; that slope
is held by its 99.9th percentile (1e-5 of the max) and its max (5e-5
rad) instead (ROADMAP section 3).  Its cos(incidence), and the
irradiances that read it, are held at 1e-5.
"""

import warnings

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import atlite_tpu
from atlite_tpu.physics import orientation as jori
from atlite_tpu.physics import thermal as jthermal
from atlite_tpu_torch import Cutout
from atlite_tpu_torch.physics import orientation as tori
from atlite_tpu_torch.physics import thermal as tthermal

torch.set_num_threads(1)

NORTH = dict(module="synthetic", x=slice(-4, 1.5), y=slice(56, 62),
             time=slice("2013-06-01", "2013-06-03"))
SOUTH = dict(module="synthetic", x=slice(110, 118), y=slice(-40, -30), dx=0.5, dy=0.5,
             time=slice("2013-03-20", "2013-03-22"))
FEATURES = ["influx", "temperature"]
TRACKING = [None, "horizontal", "tilted_horizontal", "vertical", "dual"]
ORIENTATIONS = {"flat": {"slope": 0.0, "azimuth": 0.0},
                "south30": {"slope": 30.0, "azimuth": 180.0},
                "latopt": "latitude_optimal",
                "east90": {"slope": 90.0, "azimuth": 90.0}}
REL = 1e-5


def make_pair(kw):
    with jax.enable_x64(False):
        jc = atlite_tpu.Cutout(None, **kw).prepare(features=FEATURES)
    tc = Cutout(device="cpu", **kw).prepare(features=FEATURES)
    C = tc.shape[0] * tc.shape[1]
    return jc, tc, sp.random(4, C, density=0.3, random_state=2, format="csr",
                             dtype=np.float32)


@pytest.fixture(scope="module")
def north():
    return make_pair(NORTH)


@pytest.fixture(scope="module")
def south():
    return make_pair(SOUTH)


@pytest.fixture(scope="module")
def influx_pair(north):
    """ERA5-style cutouts of the same data: global horizontal ``influx``
    instead of direct + diffuse, and a humidity field."""
    jc, tc, m = north
    data = {k: v for k, v in tc.data.items() if k not in ("influx_direct", "influx_diffuse")}
    data["influx"] = tc.data["influx_direct"] + tc.data["influx_diffuse"]
    rng = np.random.default_rng(0)
    data["humidity"] = rng.uniform(0.004, 0.012, data["temperature"].shape).astype(np.float32)
    va = {k: {"dims": ("time", "y", "x")} for k in data}
    with jax.enable_x64(False):
        jcut = atlite_tpu.Cutout(path=None, data=dict(data), grid_desc=jc.grid_desc,
                                 attrs=dict(jc.attrs), var_attrs=dict(va))
    tcut = Cutout(data=dict(data), grid_desc=tc.grid_desc, attrs=dict(tc.attrs),
                  var_attrs=dict(va), device="cpu")
    return jcut, tcut, m


def both(pair, fn, **kw):
    jc, tc = pair[:2]
    with jax.enable_x64(False), warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        want = fn(jc, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        got = fn(tc, **kw)
    return got, want


def assert_da_close(got, want, rel=REL):
    assert got.dims == want.dims and got.name == want.name and got.attrs == want.attrs
    for d in want.coords:
        w = np.asarray(want.coords[d])
        w = w.astype("datetime64[ns]") if w.dtype.kind == "M" else w
        np.testing.assert_array_equal(got.coords[d], w, err_msg=d)
    w = np.asarray(want.values)
    assert got.values.shape == w.shape and got.values.dtype == w.dtype
    np.testing.assert_array_equal(np.isnan(got.values), np.isnan(w))
    ok = ~np.isnan(w)
    err = np.abs(got.values[ok] - w[ok]).max()
    assert err <= rel * np.abs(w[ok]).max(), err


MODES = {"resident": {}, "matrix": {"matrix": True}, "streamed": {"time_chunk": 30},
         "streamed_matrix": {"time_chunk": 30, "matrix": True}}


def mode_kw(pair, mode):
    kw = dict(MODES[mode], aggregate_time=None)
    if kw.pop("matrix", False):
        kw["matrix"] = pair[2]
    return kw


@pytest.mark.parametrize("region", ["north", "south"])
@pytest.mark.parametrize("orient", sorted(ORIENTATIONS))
@pytest.mark.parametrize("tracking", TRACKING[1:])
def test_surface_orientation_equals_jax(request, region, orient, tracking):
    jc, tc, _ = request.getfixturevalue(region)
    spec = jori.get_orientation(ORIENTATIONS[orient])
    with jax.enable_x64(False):
        f = jc.fields()
        sp_ = {"altitude": f["solar_altitude"], "azimuth": f["solar_azimuth"]}
        want = jori.surface_orientation(sp_, jax.numpy.asarray(jc.grid_desc.y, "float32"),
                                        spec, tracking)
        shape = f["solar_altitude"].shape
        want = {k: np.broadcast_to(np.asarray(v), shape) for k, v in want.items()
                if k != "tracking"}
    f = tc.fields()
    got = tori.surface_orientation({"altitude": f["solar_altitude"],
                                    "azimuth": f["solar_azimuth"]},
                                   torch.as_tensor(tc.grid_desc.y, dtype=torch.float32),
                                   tori.get_orientation(ORIENTATIONS[orient]), tracking)
    for k in ("cosincidence", "slope", "azimuth"):
        g = np.broadcast_to(torch.as_tensor(got[k]).numpy(), shape)
        w = want[k]
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=k)
        ok = ~np.isnan(w)
        d = np.abs(g[ok] - w[ok])
        scale = np.abs(w[ok]).max()
        above = int((d > REL * scale).sum())
        if tracking == "tilted_horizontal" and k == "slope":
            # arccos next to 1 (ROADMAP section 3)
            assert np.quantile(d, 0.999) <= REL * scale
            assert d.max() <= 5e-5, (d.max(), above)
        else:
            assert above == 0, (k, d.max(), scale)


def test_tilted_horizontal_slope_flip_is_the_recorded_one(south):
    """The input recorded in ROADMAP section 3: the southern cutout, a
    flat axis (tilt 0): the slope differs by 2.45e-5 rad at most, and the
    PV output it feeds stays within 1e-5 of its max."""
    jc, tc, _ = south
    spec = {"slope": 0.0, "azimuth": 0.0}
    with jax.enable_x64(False):
        f = jc.fields()
        want = np.asarray(jori.surface_orientation(
            {"altitude": f["solar_altitude"], "azimuth": f["solar_azimuth"]},
            jax.numpy.asarray(jc.grid_desc.y, "float32"), jori.get_orientation(spec),
            "tilted_horizontal")["slope"])
    f = tc.fields()
    got = tori.surface_orientation({"altitude": f["solar_altitude"],
                                    "azimuth": f["solar_azimuth"]},
                                   torch.as_tensor(tc.grid_desc.y, dtype=torch.float32),
                                   tori.get_orientation(spec), "tilted_horizontal")["slope"]
    d = np.abs(got.numpy() - want)
    assert 1e-5 < d.max() <= 5e-5
    pv_got, pv_want = both(south, lambda c, **k: c.pv(**k), panel="CSi", orientation=spec,
                           tracking="tilted_horizontal", aggregate_time=None)
    assert_da_close(pv_got, pv_want)


@pytest.mark.parametrize("mode", ["resident", "streamed_matrix"])
@pytest.mark.parametrize("trigon_model", ["simple", "hay_davies"])
@pytest.mark.parametrize("kind", ["total", "direct", "diffuse", "ground"])
def test_irradiation_equals_jax(north, kind, trigon_model, mode):
    got, want = both(north, lambda c, **k: c.irradiation(**k), orientation="latitude_optimal",
                     irradiation=kind, trigon_model=trigon_model, **mode_kw(north, mode))
    assert_da_close(got, want)
    assert got.attrs["units"] == ("W m**-2" if mode == "resident" else "MW")


@pytest.mark.parametrize("mode", ["resident", "matrix", "streamed_matrix"])
@pytest.mark.parametrize("trigon_model", ["simple", "hay_davies"])
@pytest.mark.parametrize("tracking", TRACKING)
def test_pv_tracking_equals_jax(north, tracking, trigon_model, mode):
    got, want = both(north, lambda c, **k: c.pv(**k), panel="CSi",
                     orientation={"slope": 30.0, "azimuth": 180.0}, tracking=tracking,
                     trigon_model=trigon_model, **mode_kw(north, mode))
    assert_da_close(got, want)


@pytest.mark.parametrize("tracking", ["horizontal", "dual"])
def test_irradiation_with_tracking_equals_jax(south, tracking):
    for trigon_model in ("simple", "hay_davies"):
        got, want = both(south, lambda c, **k: c.irradiation(**k), orientation="latitude_optimal",
                         tracking=tracking, trigon_model=trigon_model, aggregate_time=None)
        assert_da_close(got, want)


def test_dual_simple_reads_the_sun_as_slope(north):
    """Only the simple model takes sin(altitude) for the dual tracker's
    cos(slope); Hay-Davies reads the static slope, so its ground term (the
    one term that reads the slope alone) is the vertical tracker's."""
    tc = north[1]
    kw = dict(orientation={"slope": 30.0, "azimuth": 180.0}, aggregate_time=None,
              irradiation="ground")
    dual = tc.irradiation(tracking="dual", **kw).values
    vertical = tc.irradiation(tracking="vertical", **kw).values
    assert not np.allclose(dual, vertical)
    hd = dict(kw, trigon_model="hay_davies")
    np.testing.assert_array_equal(tc.irradiation(tracking="dual", **hd).values,
                                  tc.irradiation(tracking="vertical", **hd).values)


@pytest.mark.parametrize("mode", ["resident", "streamed", "streamed_matrix"])
# the lossy collector still keeps most of its gain: at c0 = 0.5, c1 = 10
# the output (max ~13 W/m^2) is the difference of float32 terms of ~500
# and holds only ~1e-5 of them
@pytest.mark.parametrize("collector", [{}, {"c0": 0.7, "c1": 4.0, "t_store": 60.0},
                                       {"orientation": "latitude_optimal",
                                        "trigon_model": "hay_davies"}],
                         ids=["default", "lossy", "latopt_hay_davies"])
def test_solar_thermal_equals_jax(north, collector, mode):
    got, want = both(north, lambda c, **k: c.solar_thermal(**k), **collector,
                     **mode_kw(north, mode))
    assert_da_close(got, want)
    if mode == "resident":
        assert "units" not in got.attrs and (got.values >= 0).all() and got.values.max() > 0


def test_solar_thermal_output_at_zero_irradiance():
    """A zero irradiance gives a loss ratio of 0 (nan_to_num of x / NaN),
    so a zero output, as in JAX."""
    irr = np.array([0.0, 0.0, 1e-3, 300.0, 800.0], np.float32)
    temp = np.array([250.0, 300.0, 280.0, 290.0, 300.0], np.float32)
    with jax.enable_x64(False):
        want = np.asarray(jthermal.solar_thermal_output(irr, temp, 0.8, 3.0, 80.0))
    got = tthermal.solar_thermal_output(torch.tensor(irr), torch.tensor(temp), 0.8, 3.0, 80.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert (got[:3] == 0).all() and (got[3:] > 0).all()


@pytest.mark.parametrize("clearsky_model", [None, "simple", "enhanced"])
@pytest.mark.parametrize("conv", ["irradiation", "pv", "solar_thermal"])
def test_influx_cutout_equals_jax(influx_pair, conv, clearsky_model):
    fns = {"irradiation": lambda c, **k: c.irradiation(orientation="latitude_optimal",
                                                       trigon_model="hay_davies", **k),
           "pv": lambda c, **k: c.pv(panel="CSi", orientation="latitude_optimal",
                                     tracking="horizontal", **k),
           "solar_thermal": lambda c, **k: c.solar_thermal(**k)}
    kw = {} if clearsky_model is None and conv == "solar_thermal" else \
        {"clearsky_model": clearsky_model}
    for extra in ({}, {"time_chunk": 30}):
        got, want = both(influx_pair, fns[conv], aggregate_time=None, **kw, **extra)
        assert_da_close(got, want)
    resident = fns[conv](influx_pair[1], aggregate_time=None, **kw).values
    np.testing.assert_allclose(got.values, resident, rtol=1e-6, atol=1e-6)


def test_influx_cutout_automatic_clearsky_is_enhanced(influx_pair):
    """With temperature and humidity stored, clearsky_model=None takes the
    enhanced model, streamed too (the streamer stages humidity)."""
    tc = influx_pair[1]
    kw = dict(orientation="latitude_optimal", aggregate_time=None)
    auto = tc.irradiation(**kw).values
    np.testing.assert_array_equal(auto, tc.irradiation(clearsky_model="enhanced", **kw).values)
    assert not np.allclose(auto, tc.irradiation(clearsky_model="simple", **kw).values)
    np.testing.assert_allclose(tc.irradiation(time_chunk=25, **kw).values, auto,
                               rtol=1e-6, atol=1e-6)
