"""Runoff, the rolling mean, and the streaming contract of every
converter: the port against the JAX package on the same synthetic
cutouts, on the CPU, JAX with x64 off.

Covered: ``runoff`` with and without height weighting, smoothing (a
week, 24 h, False), the lower-threshold quantile and the yearly
normalisation (a per-bus table, reordered columns, a DatetimeIndex, a
scalar Series; the port also takes a plain dict) over a full year;
``DataArray.rolling_mean`` with NaN, windows past T and ``min_periods``;
``_streaming_vars`` and the ``_time_elementwise``/``_day_aligned``
markers of every converter; the Cutout's bindings; every new converter
streamed int16 against JAX's int16.

Tolerance: 1e-5 * max|JAX| in absolute terms, NaN masks identical.  The
solar converters packed against packed: the codes are equal and only the
float32 rebuild may round apart, which can flip the low-sun cutoff of an
isolated cell-hour (ROADMAP section 3), so their bulk is held by its
99.9th percentile (1e-5 of the max) and their maximum by 2e-2 of the max,
as in ``tests/test_torch_convert.py``.
"""

import warnings

import jax
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

import atlite_tpu
from atlite_tpu import convert as jconv
from atlite_tpu.dataarray import DataArray as JDataArray
from atlite_tpu_torch import Cutout
from atlite_tpu_torch import convert as tconv
from atlite_tpu_torch.dataarray import DataArray

torch.set_num_threads(1)

KW = dict(module="synthetic", x=slice(-4, 1.5), y=slice(56, 62),
          time=slice("2013-06-01", "2013-06-03"))
YEAR = dict(module="synthetic", x=slice(-1, 0), y=slice(50, 51), time="2013")
ALL = ["wind", "influx", "temperature", "height", "runoff"]
REL = 1e-5


@pytest.fixture(scope="module")
def pair():
    with jax.enable_x64(False):
        jc = atlite_tpu.Cutout(None, **KW).prepare(features=ALL)
    tc = Cutout(device="cpu", **KW).prepare(features=ALL)
    C = tc.shape[0] * tc.shape[1]
    return jc, tc, sp.random(5, C, density=0.3, random_state=7, format="csr", dtype=np.float32)


@pytest.fixture(scope="module")
def year():
    """A full year on 5 x 5 cells: the yearly normalisation needs one."""
    with jax.enable_x64(False):
        jc = atlite_tpu.Cutout(None, **YEAR).prepare(features=["runoff", "height"])
    tc = Cutout(device="cpu", **YEAR).prepare(features=["runoff", "height"])
    return jc, tc


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


def runoff(c, **kw):
    return c.runoff(**kw)


RUNOFF = {
    "plain": dict(),
    "unweighted_streamed": dict(weight_with_height=False, time_chunk=25),
    "week_smooth": dict(smooth=True),
    "smooth24_threshold_layout": dict(smooth=24, lower_threshold_quantile=0.5, layout=True),
    "threshold_true_matrix": dict(lower_threshold_quantile=True, matrix=True),
    "smooth_false_streamed_matrix": dict(smooth=False, matrix=True, time_chunk=30),
    "int16_matrix": dict(matrix=True, time_chunk=30, stream_pack="int16"),
}


@pytest.mark.parametrize("case", sorted(RUNOFF))
def test_runoff_equals_jax(pair, case):
    kw = dict(RUNOFF[case], aggregate_time=None)
    if kw.pop("matrix", False):
        kw["matrix"] = pair[2]
    if kw.pop("layout", False):
        kw["layout"] = np.random.default_rng(3).random(pair[1].shape)
    got, want = both(pair, runoff, **kw)
    assert_da_close(got, want)


def test_runoff_weighting_and_threshold(pair):
    tc = pair[1]
    raw = tc.runoff(weight_with_height=False, aggregate_time=None).values
    weighted = tc.runoff(aggregate_time=None).values
    np.testing.assert_allclose(weighted, raw * tc.data["height"][None], rtol=1e-6)
    thr = tc.runoff(lower_threshold_quantile=0.5, aggregate_time=None).values
    assert (thr == 0).sum() >= thr.size // 2 - 1


def target_cases(index):
    """(port stats, JAX stats) pairs for one bus (``index`` None) or for
    the two buses 0 and 1."""
    if index is None:
        return {
            "frame": (pd.DataFrame({0: [1234.5]}, index=[2013]),) * 2,
            "datetime_index": (pd.DataFrame({0: [777.0]},
                                            index=pd.DatetimeIndex(["2013-01-01"])),) * 2,
            "series": (pd.Series([321.0, 5.0], index=[2013, 2015]),) * 2,
            "dict": ({2013: 1234.5}, pd.Series([1234.5], index=[2013])),
        }
    frame = pd.DataFrame({1: [100.0], 0: [300.0]}, index=[2013])  # columns reordered
    return {"frame": (frame, frame),
            "dict": ({2013: {1: 100.0, 0: 300.0}}, frame)}


@pytest.mark.parametrize("buses", [1, 2])
def test_runoff_normalize_using_yearly_equals_jax(year, buses):
    jc, tc = year
    layout = np.ones(tc.shape)
    if buses == 1:
        kw, expected = dict(layout=layout), None
    else:
        m = sp.csr_matrix(np.vstack([2 * layout.ravel(), layout.ravel()]))
        kw, expected = dict(matrix=m, index=pd.Index([0, 1], name="bus")), [300.0, 100.0]
    for name, (tstats, jstats) in target_cases(None if buses == 1 else 2).items():
        with jax.enable_x64(False):
            want = jc.runoff(normalize_using_yearly=jstats, aggregate_time=None, **kw)
        got = tc.runoff(normalize_using_yearly=tstats, aggregate_time=None, **kw)
        assert_da_close(got, want)
        sums = got.values.sum(axis=1)  # float32 sums of 8760 hours
        if expected is None:
            total = {"frame": 1234.5, "datetime_index": 777.0, "series": 321.0,
                     "dict": 1234.5}[name]
            np.testing.assert_allclose(sums, [total], rtol=1e-5)
        else:
            np.testing.assert_allclose(sums, expected, rtol=1e-5)


def test_runoff_normalize_needs_a_full_year(pair):
    with pytest.raises(ValueError, match="full year"):
        pair[1].runoff(layout=np.ones(pair[1].shape), normalize_using_yearly={2013: 1.0},
                       aggregate_time=None)


@pytest.mark.parametrize("window, min_periods", [(1, 1), (3, 1), (5, 3), (24, 1), (500, 1),
                                                 (4, 0)])
def test_rolling_mean_equals_jax(window, min_periods):
    rng = np.random.default_rng(window)
    v = rng.uniform(0.0, 1.0, (3, 40))
    v[0, 5:9] = np.nan
    v[1, ::7] = np.nan
    v[2, :] = np.nan
    coords = {"bus": np.arange(3), "time": np.arange(40)}
    got = DataArray(v.astype(np.float32), coords=coords, dims=("bus", "time"))
    want = JDataArray(v.astype(np.float32), coords=coords, dims=("bus", "time"))
    g = got.rolling_mean("time", window, min_periods=min_periods).values
    w = np.asarray(want.rolling_mean("time", window, min_periods=min_periods).values)
    assert g.dtype == w.dtype == np.float64
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_allclose(g, w, rtol=1e-12)
    # time first
    t = DataArray(v.T.astype(np.float32), coords=coords, dims=("time", "bus"))
    np.testing.assert_allclose(t.rolling_mean("time", window, min_periods).values, g.T,
                               rtol=1e-12)
    with pytest.raises(ValueError, match="window"):
        got.rolling_mean("time", 0)


STREAMING_KWARGS = {
    "convert_wind": [dict(turbine={"hub_height": 100.0}),
                     dict(turbine={"hub_height": 80.0}, interpolation_method="power")],
    "convert_pv": [dict()], "convert_irradiation": [dict()], "convert_solar_thermal": [dict()],
    "convert_csp": [dict()], "convert_temperature": [dict()],
    "convert_soil_temperature": [dict()], "convert_dewpoint_temperature": [dict()],
    "convert_coefficient_of_performance": [dict(source="air"), dict(source="soil")],
    "convert_heat_demand": [dict(hour_shift=3.0)], "convert_cooling_demand": [dict()],
    "convert_runoff": [dict(), dict(weight_with_height=False)],
}


@pytest.mark.parametrize("humidity", [False, True])
@pytest.mark.parametrize("name", sorted(STREAMING_KWARGS))
def test_streaming_vars_and_markers_equal_jax(pair, name, humidity):
    jc, tc = pair[:2]
    if humidity:
        hum = np.zeros_like(tc.data["temperature"])
        tc = Cutout(data={**tc.data, "humidity": hum}, grid_desc=tc.grid_desc, device="cpu",
                    attrs=dict(tc.attrs), var_attrs=dict(tc.var_attrs))
        jc = atlite_tpu.Cutout(path=None, data={**jc.data, "humidity": hum},
                               grid_desc=jc.grid_desc, attrs=dict(jc.attrs),
                               var_attrs=dict(jc.var_attrs))
    tf, jf = getattr(tconv, name), getattr(jconv, name)
    for kw in STREAMING_KWARGS[name]:
        assert tconv._streaming_vars(tc, tf, kw) == jconv._streaming_vars(jc, jf, kw), kw
    for marker in ("_time_elementwise", "_day_aligned"):
        assert getattr(tf, marker, False) == getattr(jf, marker, False), marker


def test_cutout_binds_every_jax_converter():
    bound = [n for n, v in vars(atlite_tpu.Cutout).items()
             if callable(v) and getattr(jconv, n, None) is v]
    assert len(bound) == 15
    for n in bound:
        assert getattr(Cutout, n) is getattr(tconv, n), n


INT16 = {
    "irradiation_hay_davies": (lambda c, **k: c.irradiation(
        orientation="latitude_optimal", trigon_model="hay_davies", **k), True),
    "pv_dual": (lambda c, **k: c.pv(panel="CSi", orientation="latitude_optimal",
                                    tracking="dual", **k), True),
    "solar_thermal": (lambda c, **k: c.solar_thermal(**k), True),
    "csp_tower": (lambda c, **k: c.csp("SAM_solar_tower", **k), True),
    "dewpoint_temperature": (lambda c, **k: c.dewpoint_temperature(**k), False),
    "cooling_demand": (lambda c, **k: c.cooling_demand(threshold=10.0, **k), False),
    "runoff": (lambda c, **k: c.runoff(**k), False),
}


@pytest.mark.parametrize("conv", sorted(INT16))
def test_streamed_int16_equals_jax_int16(pair, conv):
    fn, solar = INT16[conv]
    got, want = both(pair, fn, matrix=pair[2], aggregate_time=None, time_chunk=20,
                     stream_pack="int16")
    w = np.asarray(want.values)
    np.testing.assert_array_equal(np.isnan(got.values), np.isnan(w))
    diff = np.abs(got.values - w)
    scale = np.abs(w).max()
    if solar:
        assert np.quantile(diff, 0.999) <= REL * scale
        assert diff.max() <= 2e-2 * scale
    else:
        assert diff.max() <= REL * scale
    resident = fn(pair[1], matrix=pair[2], aggregate_time=None).values
    assert np.abs(got.values - resident).max() <= 2e-2 * scale
