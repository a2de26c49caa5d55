"""The port's input recipe and calendar math against the JAX package's.

The port computes Julian dates from numpy datetime64 in pandas' order of
operations, so the inputs are held at rtol 1e-6 (as the float32 fields are
cast from float64) and in practice come out equal.
"""

import numpy as np
import pandas as pd
import pytest

import __graft_entry__ as ge
import bench
from atlite_tpu.core import timeutil as jtime
from atlite_tpu_torch import build_inputs, example_inputs
from atlite_tpu_torch.core import timeutil as ttime


def assert_inputs_close(got, want):
    (gf, ge_, *grest), (wf, we, *wrest) = got, want
    assert set(gf) == set(wf) and set(ge_) == set(we)
    for k in wf:
        assert gf[k].dtype == wf[k].dtype and gf[k].shape == wf[k].shape
        np.testing.assert_allclose(gf[k], wf[k], rtol=1e-6, err_msg=k)
    for k in we:
        np.testing.assert_allclose(ge_[k], we[k], rtol=1e-6, atol=1e-7, err_msg=k)
    for g, w in zip(grest, wrest):
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=1e-6)


@pytest.mark.parametrize("kwargs", [{}, dict(T=30, Y=7, X=13, B=3, seed=5, start="2013-12-31 20:00")])
def test_example_inputs(kwargs):
    assert_inputs_close(example_inputs(**kwargs), ge._example_inputs(**kwargs))


@pytest.mark.parametrize("shape", [(48, 16, 24, 5), (30, 7, 13, 3)])
def test_build_inputs(shape):
    assert_inputs_close(build_inputs(*shape), bench.build_inputs(*shape))


@pytest.mark.parametrize("shift", ["0h", "-30min", "90s", "+2h"])
def test_solar_ephemeris(shift):
    times = pd.date_range("2011-02-27 13:00", periods=80, freq="7h").values
    got = ttime.solar_ephemeris(times, time_shift=shift)
    want = jtime.solar_ephemeris(times, time_shift=shift)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-12)


def test_julian_date_and_calendar_fields():
    times = pd.DatetimeIndex(["1999-12-31 23:59:59.5", "2000-02-29 12:00",
                              "2013-01-01", "2024-03-01 06:30:15.000001",
                              "1969-07-20 20:17:40"])
    np.testing.assert_array_equal(ttime.to_julian_date(times.values),
                                  times.to_julian_date().values)
    cal = ttime.calendar_fields(times.values)
    for k in ("year", "month", "day", "hour", "minute", "second",
              "microsecond", "nanosecond", "dayofyear"):
        np.testing.assert_array_equal(cal[k], getattr(times, k), err_msg=k)


def test_parse_timedelta():
    for s in ("0h", "-30min", "30 min", "2hours", "1.5h", "-1D", "250ms", "15s"):
        assert ttime.parse_timedelta(s) == pd.to_timedelta(s).to_timedelta64(), s
    with pytest.raises(ValueError):
        ttime.parse_timedelta("half an hour")
