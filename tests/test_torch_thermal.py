"""The temperature family, heat-pump COP and degree-day demand: the port
against the JAX package on the same synthetic cutout, on the CPU, JAX
with x64 off.

Covered: the physics functions on the same arrays (``daily_mean``'s
``index_add_`` against JAX's segment sum, the degree-day clip);
``daily_groups`` with hour shifts, over a month boundary; every converter
resident, with a matrix, streamed raw in 100 h chunks (not a whole number
of days: the demand streamer snaps to day edges) and over a month
boundary, and streamed int16 against JAX's int16; soil temperature's NaN
sea cells, zero in every mode; the chunk bounds of both packages.

Tolerance: 1e-5 * max|JAX| in absolute terms, NaN masks identical, the
same dims, coords, attrs and name.  int16 against int16: the codes are
equal and only the float32 rebuild may round apart, so the same bound.
"""

import warnings

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import atlite_tpu
from atlite_tpu import convert as jconv
from atlite_tpu.core import timeutil as jtime
from atlite_tpu.physics import thermal as jthermal
from atlite_tpu_torch import Cutout
from atlite_tpu_torch import convert as tconv
from atlite_tpu_torch.core import timeutil as ttime
from atlite_tpu_torch.physics import thermal as tthermal

torch.set_num_threads(1)

# 168 h from Jan 28: a month boundary, 11 x 9 cells with sea (NaN soil)
WEEK = dict(module="synthetic", bounds=(-4.0, 56.0, -1.5, 58.0),
            time=slice("2013-01-28", "2013-02-03"))
REL = 1e-5


@pytest.fixture(scope="module")
def pair():
    with jax.enable_x64(False):
        jc = atlite_tpu.Cutout(None, **WEEK).prepare(features=["temperature"])
    tc = Cutout(device="cpu", **WEEK).prepare(features=["temperature"])
    C = tc.shape[0] * tc.shape[1]
    m = sp.random(5, C, density=0.4, random_state=3, format="csr", dtype=np.float32)
    return jc, tc, m


def both(pair, fn, **kw):
    """(port result, JAX result) of one call."""
    jc, tc = pair[:2]
    with jax.enable_x64(False), warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        want = fn(jc, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        got = fn(tc, **kw)
    return got, want


def assert_da_close(got, want, rel=REL):
    assert isinstance(got.values, np.ndarray)
    assert got.dims == want.dims and got.name == want.name and got.attrs == want.attrs
    for d in want.coords:
        w = np.asarray(want.coords[d])
        w = w.astype("datetime64[ns]") if w.dtype.kind == "M" else w
        np.testing.assert_array_equal(got.coords[d], w, err_msg=d)
    w = np.asarray(want.values)
    assert got.values.shape == w.shape and got.values.dtype == w.dtype
    np.testing.assert_array_equal(np.isnan(got.values), np.isnan(w))
    ok = ~np.isnan(w)
    if ok.any():
        err = np.abs(got.values[ok] - w[ok]).max()
        assert err <= rel * np.abs(w[ok]).max(), err


CONVERTERS = {
    "temperature": lambda c, **k: c.temperature(**k),
    "soil_temperature": lambda c, **k: c.soil_temperature(**k),
    "dewpoint_temperature": lambda c, **k: c.dewpoint_temperature(**k),
    "cop_air": lambda c, **k: c.coefficient_of_performance(**k),
    "cop_soil": lambda c, **k: c.coefficient_of_performance(source="soil", sink_T=45.0, **k),
    "heat_demand": lambda c, **k: c.heat_demand(**k),
    "heat_demand_shift": lambda c, **k: c.heat_demand(hour_shift=4.0, threshold=17.0, **k),
    "cooling_demand": lambda c, **k: c.cooling_demand(threshold=-5.0, a=2.0, constant=0.5,
                                                      **k),
}


# ---- physics

def test_physics_functions_equal_jax():
    rng = np.random.default_rng(0)
    T = rng.uniform(250.0, 300.0, (30, 4, 5)).astype(np.float32)
    soil = T.copy()
    soil[:, 0, :2] = np.nan
    fields = {"temperature": T, "soil temperature": soil, "dewpoint temperature": T - 3}
    tf = {k: torch.tensor(v) for k, v in fields.items()}
    with jax.enable_x64(False):
        want = [np.asarray(f(fields)) for f in (jthermal.temperature_celsius,
                                               jthermal.soil_temperature_celsius,
                                               jthermal.dewpoint_temperature_celsius)]
        cop = np.asarray(jthermal.coefficient_of_performance(want[1], 55.0, 8.77, -0.15,
                                                             0.000734))
    got = [f(tf).numpy() for f in (tthermal.temperature_celsius,
                                    tthermal.soil_temperature_celsius,
                                    tthermal.dewpoint_temperature_celsius)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[1][:, 0, :2] == 0).all()
    np.testing.assert_array_equal(
        tthermal.coefficient_of_performance(torch.tensor(got[1]), 55.0, 8.77, -0.15,
                                            0.000734).numpy(), cop)
    assert tthermal.COP_COEFFS == jthermal.COP_COEFFS


@pytest.mark.parametrize("kind", ["heat", "cooling"])
def test_daily_mean_and_demand_equal_jax(kind):
    rng = np.random.default_rng(1)
    field = rng.uniform(260.0, 300.0, (50, 3, 4)).astype(np.float32)
    ids = np.repeat(np.arange(3), [7, 24, 19]).astype(np.int32)
    with jax.enable_x64(False):
        want = np.asarray(jthermal.daily_mean(field, jax.numpy.asarray(ids), 3))
        want_d = np.asarray(jthermal.degree_day_demand(want, 10.0, 1.5, 0.25, kind))
    got = tthermal.daily_mean(torch.tensor(field), ids, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(tthermal.degree_day_demand(got, 10.0, 1.5, 0.25, kind).numpy(),
                               want_d, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("hour_shift", [0.0, 4.0, 8.0, -7.5, 30.0])
@pytest.mark.parametrize("time", [slice("2013-01-28", "2013-02-03"), "2012-02"])
def test_daily_groups_equal_jax(time, hour_shift):
    from atlite_tpu.core.grid import coordinate_range

    _, _, stamps = coordinate_range(slice(0, 1), slice(0, 1), time)
    days, ids = ttime.daily_groups(np.asarray(stamps, dtype="datetime64[ns]"), hour_shift)
    jdays, jids = jtime.daily_groups(stamps, hour_shift)
    np.testing.assert_array_equal(days, jdays.values)
    assert days.dtype == np.dtype("datetime64[ns]")
    np.testing.assert_array_equal(ids, jids)
    assert ids.dtype == np.int32


# ---- converters

@pytest.mark.parametrize("mode", ["resident", "matrix", "streamed", "streamed_matrix"])
@pytest.mark.parametrize("conv", sorted(CONVERTERS))
def test_converter_equals_jax(pair, conv, mode):
    """100 h chunks: not a whole number of days, and the week crosses
    Jan 31 -> Feb 1."""
    kw = {"aggregate_time": None}
    if "matrix" in mode:
        kw["matrix"] = pair[2]
    if mode.startswith("streamed"):
        kw["time_chunk"] = 100
    got, want = both(pair, CONVERTERS[conv], **kw)
    assert_da_close(got, want)
    if "demand" in conv:
        assert got.sizes["time"] == (8 if conv == "heat_demand_shift" else 7)


@pytest.mark.parametrize("chunk", [24, 30, 40, 49, 100])
@pytest.mark.parametrize("hour_shift", [0.0, 8.0])
def test_streamed_demand_equals_resident_over_month_boundary(pair, hour_shift, chunk):
    tc = pair[1]
    full = tc.heat_demand(aggregate_time=None, hour_shift=hour_shift)
    part = tc.heat_demand(aggregate_time=None, hour_shift=hour_shift, time_chunk=chunk)
    np.testing.assert_array_equal(part.coords["time"], full.coords["time"])
    np.testing.assert_allclose(part.values, full.values, rtol=1e-6, atol=1e-6)
    assert np.datetime64("2013-02-01", "ns") in part.coords["time"]


@pytest.mark.parametrize("hour_shift", [0.0, 8.0])
@pytest.mark.parametrize("chunk", [24, 40, 100, 500])
def test_chunk_bounds_equal_jax(pair, chunk, hour_shift):
    jc, tc = pair[:2]
    for tf, jf in ((tconv.convert_heat_demand, jconv.convert_heat_demand),
                   (tconv.convert_temperature, jconv.convert_temperature)):
        kw = {"hour_shift": hour_shift}
        assert (tconv._chunk_bounds(tc, tf, chunk, kw)
                == jconv._chunk_bounds(jc, jf, chunk, kw))


def test_soil_temperature_zero_at_sea(pair):
    tc = pair[1]
    raw = tc.data["soil temperature"]
    sea = np.isnan(raw)
    assert sea.any() and (~sea).any()
    for kw in ({}, {"time_chunk": 100}, {"time_chunk": 100, "stream_pack": "int16"}):
        for fn in (CONVERTERS["soil_temperature"], CONVERTERS["cop_soil"]):
            out = fn(tc, aggregate_time=None, **kw).values
            assert not np.isnan(out).any()
    out = tc.soil_temperature(aggregate_time=None).values
    assert (out[sea] == 0).all()
    np.testing.assert_allclose(out[~sea], raw[~sea] - np.float32(273.15), rtol=1e-6)


@pytest.mark.parametrize("matrix", [False, True])
@pytest.mark.parametrize("conv", ["cop_soil", "soil_temperature", "heat_demand", "temperature"])
def test_streamed_int16_equals_jax_int16(pair, conv, matrix):
    """int16 against int16, and the soil source's sea cells: the 65535
    sentinel rebuilds NaN, which the converter turns into the resident
    call's 0 degC (so the same COP there)."""
    kw = dict(aggregate_time=None, time_chunk=100, stream_pack="int16")
    if matrix:
        kw["matrix"] = pair[2]
    got, want = both(pair, CONVERTERS[conv], **kw)
    assert_da_close(got, want)
    resident = CONVERTERS[conv](pair[1], aggregate_time=None,
                                **({"matrix": pair[2]} if matrix else {}))
    scale = np.abs(resident.values).max()
    assert np.abs(got.values - resident.values).max() <= 1e-3 * scale
    if conv in ("cop_soil", "soil_temperature") and not matrix:
        sea = np.isnan(pair[1].data["soil temperature"])
        np.testing.assert_array_equal(got.values[sea], resident.values[sea])


def test_cop_other_source_raises(pair):
    with pytest.raises(NotImplementedError, match="air"):
        pair[1].coefficient_of_performance(source="water", aggregate_time=None)


def test_demand_complementary_and_daily(pair):
    tc = pair[1]
    heat = tc.heat_demand(threshold=0.0, aggregate_time=None)
    cool = tc.cooling_demand(threshold=0.0, aggregate_time=None)
    assert heat.name == "heat_demand" and cool.name == "cooling_demand"
    assert ((heat.values == 0) | (cool.values == 0)).all()
    T = tc.data["temperature"].astype(np.float64)
    np.testing.assert_allclose(heat.values[0], np.clip(273.15 - T[:24].mean(axis=0), 0, None),
                               rtol=1e-5, atol=1e-4)
