"""Golden values from outside the repository, on the port; the OEDB
turbine search and the yearly time helpers against the JAX package's.

The external values are ``tests/test_goldens.py``'s: the June solstice
and March equinox declination, the NREL SPA worked example, the equation
of time, the solar noon, Reindl's diffuse fraction, a Hay-Davies cell and
Huld's efficiency by hand, and datasheet points of a power curve.  They
run through the port's torch functions in float64 (the JAX tests' own
tolerances, which ran under x64) and in float32, as on the card (the same
tolerances where they are stated in degrees or minutes; rtol 1e-5 for
the rest).

The OEDB search runs against the same mocked rows and the same
``monkeypatch`` of ``requests.get`` in both packages: every field of the
config, the registry name, the three ``RuntimeError``s (messages equal)
and the warning.  ``julian_day_offset`` and ``yearly_groups`` equal
JAX's exactly over a year, a leap year and a span across years.
"""

import logging

import numpy as np
import pandas as pd
import pytest
import requests
import torch

import atlite_tpu.core.timeutil as jtime
import atlite_tpu.resource as jres
from atlite_tpu_torch.core import timeutil
from atlite_tpu_torch import resource
from atlite_tpu_torch.physics.irradiation import diffuse_horizontal_fraction, tilted_irradiation
from atlite_tpu_torch.physics.pv import power_huld
from atlite_tpu_torch.physics.solar import solar_position, solar_position_numpy
from atlite_tpu_torch.physics.wind import power_curve

DTYPES = [torch.float64, torch.float32]
RTOL = {torch.float64: 1e-6, torch.float32: 1e-5}


def position(ts, lon, lat, dtype=None):
    """(declination, altitude, azimuth) in degrees: by the numpy path, or
    by the torch path in ``dtype``."""
    eph = timeutil.solar_ephemeris(np.array([ts], dtype="datetime64[ns]"))
    if dtype is None:
        sp = solar_position_numpy(eph["declination"], eph["hour_angle0"],
                                  np.array([lon]), np.array([lat]))
        alt, az = sp["altitude"][0, 0, 0], sp["azimuth"][0, 0, 0]
    else:
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype)  # noqa: E731
        sp = solar_position(t(eph["declination"]), t(eph["hour_angle0"]), t([lon]), t([lat]))
        alt, az = float(sp["altitude"][0, 0, 0]), float(sp["azimuth"][0, 0, 0])
    return np.degrees(eph["declination"][0]), np.degrees(alt), np.degrees(az)


PATHS = [None, torch.float64, torch.float32]
PATH_IDS = ["numpy", "float64", "float32"]


@pytest.mark.parametrize("dtype", PATHS, ids=PATH_IDS)
def test_solstice_declination_is_obliquity(dtype):
    dec, _, _ = position("2013-06-21 05:04", 0.0, 50.0, dtype)
    assert abs(dec - 23.437) < 0.02


def test_equinox_declination_is_zero():
    dec, _, _ = position("2013-03-20 11:02", 0.0, 50.0)
    assert abs(dec) < 0.03


@pytest.mark.parametrize("dtype", PATHS, ids=PATH_IDS)
def test_nrel_spa_worked_example(dtype):
    """Reda & Andreas (2004), NREL/TP-560-34302: azimuth 194.34024 deg,
    unrefracted elevation ~39.872 deg."""
    _, alt, az = position("2003-10-17 19:30:30", -105.1786, 39.742476, dtype)
    assert abs(az - 194.34024) < 0.1
    assert abs(alt - 39.872) < 0.05


def test_equation_of_time_extremes():
    def eot_minutes(day):
        eph = timeutil.solar_ephemeris(np.array([f"{day}T12:00"], dtype="datetime64[ns]"))
        return eph["hour_angle0"][0] / (2 * np.pi) * 24 * 60

    assert abs(eot_minutes("2013-11-03") - 16.4) < 0.6
    assert abs(eot_minutes("2013-02-11") - (-14.2)) < 0.6


@pytest.mark.parametrize("dtype", PATHS, ids=PATH_IDS)
def test_solar_noon_altitude_and_azimuth(dtype):
    dec, alt, az = position("2013-06-21 12:02", 0.0, 52.0, dtype)
    assert abs(az - 180.0) < 0.5
    assert abs(alt - (90.0 - 52.0 + dec)) < 0.02


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_reindl_simple_fractions_hand_computed(dtype):
    sina = np.sin(np.radians(30.0))
    f = diffuse_horizontal_fraction(torch.tensor([0.2, 0.5, 0.85], dtype=dtype),
                                    torch.full((3,), sina, dtype=dtype))
    np.testing.assert_allclose(f.numpy(), [0.97535, 0.6140, 0.3221], atol=2e-6)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_hay_davies_hand_computed_cell(dtype):
    mk = lambda v: torch.full((1, 1, 1), v, dtype=dtype)  # noqa: E731
    fields = {"influx_direct": mk(600.0), "influx_diffuse": mk(200.0),
              "influx_toa": mk(1100.0), "albedo": mk(0.2)}
    sp = {"altitude": mk(np.radians(50.0)), "azimuth": mk(np.radians(180.0))}
    surf = {"slope": mk(np.radians(30.0)), "cosincidence": mk(0.9)}

    sina = np.sin(np.radians(50.0))
    Rb = 0.9 / sina
    A = 600.0 / 1100.0
    brightening = np.sqrt(600.0 / 800.0)
    iso = (1 - A) * (1 + np.cos(np.radians(30.0))) / 2.0 \
        * (1 + brightening * np.sin(np.radians(15.0)) ** 3)
    exp_diffuse = (iso + A * Rb) * 200.0
    exp_direct = Rb * 600.0
    exp_ground = 800.0 * 0.2 * (1 - np.cos(np.radians(30.0))) / 2.0

    total = float(tilted_irradiation(fields, sp, surf, trigon_model="hay-davies")[0, 0, 0])
    np.testing.assert_allclose(total, exp_direct + exp_diffuse + exp_ground, rtol=RTOL[dtype])
    diffuse = float(tilted_irradiation(fields, sp, surf, trigon_model="hay-davies",
                                       irradiation="diffuse")[0, 0, 0])
    np.testing.assert_allclose(diffuse, exp_diffuse, rtol=RTOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_huld_relative_efficiency_hand_computed(dtype):
    pc = {"model": "huld", "efficiency": 0.1, "r_irradiance": 1000.0,
          "r_tmod": 298.0, "c_temp_amb": 1.0, "c_temp_irrad": 0.035,
          "inverter_efficiency": 1.0, "k_1": -0.017162, "k_2": -0.040289,
          "k_3": -0.004681, "k_4": 0.000148, "k_5": 0.000169,
          "k_6": 0.000005}
    t_amb = (298.0 - 0.035 * 200.0) / 1.0
    out = float(power_huld(torch.tensor([200.0], dtype=dtype),
                           torch.tensor([t_amb], dtype=dtype), pc)[0])
    ln = np.log(0.2)
    eff = 1 + (-0.017162) * ln + (-0.040289) * ln**2
    np.testing.assert_allclose(out, 0.2 * eff, rtol=RTOL[dtype])
    np.testing.assert_allclose(out, 0.18465234, rtol=RTOL[dtype])
    at_stc = float(power_huld(torch.tensor([1000.0], dtype=dtype),
                              torch.tensor([298.0 - 35.0], dtype=dtype), pc)[0])
    np.testing.assert_allclose(at_stc, 1.0, rtol=RTOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_power_curve_datasheet_points(dtype):
    """The port's gather power curve on the shipped Vestas V112 3MW curve."""
    conf = resource.get_windturbineconfig("Vestas_V112_3MW")
    wnd = torch.tensor([3.0, 8.0, 8.5, 9.0, 13.0, 26.0], dtype=dtype)
    out = power_curve(wnd, torch.as_tensor(conf["V"], dtype=dtype),
                      torch.as_tensor(conf["POW"], dtype=dtype), 1.0)
    np.testing.assert_allclose(out.numpy(), [0.005, 1.375, (1.375 + 1.950) / 2, 1.950, 3.06, 0.0],
                               rtol=RTOL[dtype], atol=1e-9)


# ------------------------------------------------------------- OEDB search
ROWS = [
    {"id": 7, "name": "E-101", "turbine_type": "E-101/3050",
     "manufacturer": "Enercon", "has_power_curve": True,
     "power_curve_wind_speeds": "[3, 6, 9, 12]",
     "power_curve_values": "[0, 500, 2000, 3050]",
     "hub_height": "98;103", "source": "datasheet"},
    {"id": 8, "name": "V112", "turbine_type": "V112/3000",
     "manufacturer": "Vestas", "has_power_curve": True,
     "power_curve_wind_speeds": "[3, 12]",
     "power_curve_values": "[0, 3000]",
     "hub_height": "", "source": "datasheet"},
    {"id": 9, "name": "NoCurve", "turbine_type": "X",
     "manufacturer": "Y", "has_power_curve": False,
     "power_curve_wind_speeds": None, "power_curve_values": None,
     "hub_height": "100", "source": "z"},
    {"id": 123, "name": "N-117", "turbine_type": "N117/2400",
     "manufacturer": "Nordex", "has_power_curve": True,
     "power_curve_wind_speeds": "[3.0, 7.5, 11.5, 25.0]",
     "power_curve_values": "[25.0, 1100.5, 2400.0, 2400.0]",
     "hub_height": "91", "source": "sheet; 2015"},
]


@pytest.fixture
def mocked(monkeypatch):
    """Both packages' OEDB caches empty and ``requests.get`` returning
    ROWS; the calls it received."""
    calls = []

    class Response:
        def json(self):
            return [dict(r) for r in ROWS]

    def get(url, **kw):
        calls.append((url, kw))
        return Response()

    monkeypatch.setattr(requests, "get", get)
    monkeypatch.setattr(jres, "_oedb_turbines", None)
    monkeypatch.setattr(resource, "_oedb_turbines", None)
    monkeypatch.setattr(jres, "windturbines", jres.arrowdict(jres.windturbines))
    monkeypatch.setattr(resource, "windturbines", resource.arrowdict(resource.windturbines))
    return calls


def same_config(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert type(got[k]) is type(want[k]) and got[k] == want[k], k


SEARCHES = [(("E-101",), {}), (("e-1",), {}), ((8,), {}), ((None,), {"id": 123}),
            (("N1",), {"manufacturer": "nordex"}), ((None,), {"turbine_type": "v112"}),
            ((None,), {"name": "^N-"}), (("117",), {"turbine_type": "2400"})]


@pytest.mark.parametrize("args, kw", SEARCHES, ids=[f"{a[0]}-{sorted(k)}" for a, k in SEARCHES])
def test_oedb_search_equals_jax(mocked, args, kw, caplog):
    with caplog.at_level(logging.WARNING):
        want = jres.get_oedb_windturbineconfig(*args, **kw)
    jax_warnings = [r.getMessage() for r in caplog.records]
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        got = resource.get_oedb_windturbineconfig(*args, **kw)
    assert [r.getMessage() for r in caplog.records] == jax_warnings
    same_config(got, want)
    # registered under the same name
    name = [k for k in jres.windturbines if jres.windturbines[k] is want]
    assert len(name) == 1 and resource.windturbines[name[0]] is got
    assert len(mocked) == 2  # one download a package


def test_oedb_hub_heights_and_warning(mocked, caplog):
    e101 = resource.get_oedb_windturbineconfig("E-101")
    assert e101["hub_height"] == 100.0
    np.testing.assert_allclose(e101["POW"], [0.0, 0.5, 2.0, 3.05])
    assert e101["P"] == 3.05
    assert "Enercon_E_101_3050" in resource.windturbines
    with caplog.at_level(logging.WARNING):
        v112 = resource.get_oedb_windturbineconfig(8)
    assert v112["hub_height"] == 100
    assert "No hub_height defined in dataset; assuming 100 m." in caplog.text


@pytest.mark.parametrize("args, kw", [(("does-not-exist",), {}), (("NoCurve",), {}),
                                      ((None,), {"turbine_type": "1"}),
                                      (("1",), {}), ((99,), {})],
                         ids=["none", "no_curve", "ambiguous_type", "ambiguous_name", "id"])
def test_oedb_errors_equal_jax(mocked, args, kw):
    with pytest.raises(RuntimeError) as want:
        jres.get_oedb_windturbineconfig(*args, **kw)
    with pytest.raises(RuntimeError) as got:
        resource.get_oedb_windturbineconfig(*args, **kw)
    assert str(got.value) == str(want.value)


def test_oedb_ambiguity_table_as_pandas_prints_it():
    """The ambiguity message's table, against pandas' own text of the same
    frame, short and past pandas' 60 rows."""
    rng = np.random.default_rng(0)
    for n in (2, 7, 60, 61, 150):
        rows = [{"id": int(rng.integers(-50, 10**int(rng.integers(1, 6)))),
                 "manufacturer": "Maker" + "x" * int(rng.integers(0, 12)),
                 "turbine_type": f"T-{i}/{rng.integers(1, 9000)}"} for i in range(n)]
        index = sorted(rng.choice(10 * n, n, replace=False).tolist())
        cols = ["id", "manufacturer", "turbine_type"]
        want = str(pd.DataFrame(rows, index=index)[cols])
        assert resource._rows_text(rows, index, cols) == want


def test_oedb_turbine_through_get_windturbineconfig(mocked):
    same_config(resource.get_windturbineconfig("oedb:N-117"),
                jres.get_windturbineconfig("oedb:N-117"))
    # and by the name it was registered under
    same_config(resource.get_windturbineconfig("Nordex_N117_2400"),
                jres.get_windturbineconfig("Nordex_N117_2400"))


# ------------------------------------------------------------- time helpers
SPANS = [pd.date_range("2013-01-01", "2013-12-31 23:00", freq="h"),
         pd.date_range("2016-01-01", "2016-12-31 23:00", freq="h"),
         pd.date_range("2012-11-30 17:00", "2014-02-02 05:30", freq="90min"),
         pd.DatetimeIndex(["2020-02-29 12:00:00.5", "1999-12-31 23:59:59", "2000-01-01"])]
SPAN_IDS = ["year", "leap_year", "across_years", "unordered"]


@pytest.mark.parametrize("times", SPANS, ids=SPAN_IDS)
def test_julian_day_offset_equals_jax(times):
    want = jtime.julian_day_offset(times)
    got = timeutil.julian_day_offset(times.values)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(timeutil.julian_day_offset(list(times.values)), want)


@pytest.mark.parametrize("times", SPANS, ids=SPAN_IDS)
def test_yearly_groups_equal_jax(times):
    (wy, wi), (gy, gi) = jtime.yearly_groups(times), timeutil.yearly_groups(times.values)
    assert gy.dtype == wy.dtype and gi.dtype == wi.dtype == np.int32
    np.testing.assert_array_equal(gy, wy)
    np.testing.assert_array_equal(gi, wi)
