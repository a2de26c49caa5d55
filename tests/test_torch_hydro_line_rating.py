"""Line-rating and hydro physics: the port against the JAX package, on
the CPU.

Covered: ``convert_line_rating`` on the IEEE Std 738-2012 worked example
(1025 A +-0.5%), the two datasheet cases and the right-angle symmetries
of the JAX tests, against JAX; ``batched_line_rating`` on a padded (L, K)
plan with a NaN cell (a negative heat balance), a line whose cells are
all NaN and a line with no cell, in float32 against JAX with x64 off;
``shift_and_aggregate`` against ``np.roll`` and JAX, shifts past T and 0
included; ``travel_hours`` against JAX on a pandas Series and on a dict;
``Cutout.hydro``/``line_rating`` bound to the converters (their geometry
is held against JAX in ``test_torch_hydro_line_rating_gis.py``).

Tolerance: 1e-5 * max|JAX| in absolute terms, NaN masks identical;
float64 cases (the single-line ones, as the JAX tests run them) at
rtol 1e-12.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax
from atlite_tpu.convert import convert_line_rating as jconvert_line_rating
from atlite_tpu.physics import hydro as jhydro
from atlite_tpu.physics import line_rating as jlr
from atlite_tpu_torch import Cutout
from atlite_tpu_torch.convert import convert_line_rating
from atlite_tpu_torch.physics import hydro as thydro
from atlite_tpu_torch.physics import line_rating as tlr

torch.set_num_threads(1)


def ds(**over):
    base = {"temperature": 313.0, "wnd100m": 0.61, "height": 0.0, "wnd_azimuth": 0.0,
            "influx_direct": 1027.0, "solar_altitude": np.pi / 2, "solar_azimuth": np.pi}
    base.update(over)
    return {k: np.asarray(v) for k, v in base.items()}


def rate(d, **kw):
    return float(convert_line_rating(d, device="cpu", **kw))


IEEE = dict(R=9.39e-5, D=0.02814, Ts=273 + 100, epsilon=0.8, alpha=0.8)


def test_ieee_sample_case():
    i = rate(ds(), psi=90, **IEEE)
    assert np.isclose(i, 1025, rtol=0.005)
    assert np.isclose(i, float(jconvert_line_rating(ds(), psi=90, **IEEE)), rtol=1e-12)


@pytest.mark.parametrize("case", ["oeding_oswald", "suedkabel"])
def test_datasheet_cases_equal_jax(case):
    if case == "oeding_oswald":
        d = ds(temperature=30 + 273, wnd100m=0, influx_direct=0)
        kw = dict(psi=90, R=0.1188e-3, D=0.0218, Ts=273 + 80, epsilon=0.8, alpha=0.8)
        expected = 645
    else:
        d = ds(temperature=293, wnd100m=0, influx_direct=0)
        kw = dict(psi=0, R=0.0136e-3, Ts=363)
        expected = 2460
    i = rate(d, **kw)
    assert np.isclose(i, expected, rtol=0.02)
    assert np.isclose(i, float(jconvert_line_rating(d, **kw)), rtol=1e-12)


@pytest.mark.parametrize("wnd_azimuth", [0.0, np.pi / 2, np.pi])
def test_angles_equal_jax(wnd_azimuth):
    for psi in range(0, 370, 10):
        d = ds(wnd_azimuth=wnd_azimuth)
        assert np.isclose(rate(d, psi=psi, **IEEE),
                          float(jconvert_line_rating(d, psi=psi, **IEEE)), rtol=1e-12)
    expected = rate(ds(), psi=90, **IEEE)
    assert np.isclose(rate(ds(), psi=270, **IEEE), expected, rtol=1e-12)


def test_tensors_keep_their_device_and_arrays_need_a_card(monkeypatch):
    d = {k: torch.as_tensor(v) for k, v in ds().items()}
    out = convert_line_rating(d, psi=90, **IEEE)
    assert out.device.type == "cpu" and np.isclose(float(out), 1025, rtol=0.005)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        convert_line_rating(ds(), psi=90, **IEEE)


def plan(L=7, K=4, T=9, seed=0):
    """A padded (L, K) cell plan over (T,) hours: line 2 has no cell, line 3
    one NaN cell (air hotter than the conductor), line 4 only such cells."""
    rng = np.random.default_rng(seed)
    f = {
        "temperature": rng.uniform(260.0, 310.0, (L, K, T)),
        "wnd100m": rng.uniform(0.0, 15.0, (L, K, T)),
        "height": rng.uniform(0.0, 1500.0, (L, K, 1)),
        "wnd_azimuth": rng.uniform(0.0, 2 * np.pi, (L, K, T)),
        "influx_direct": rng.uniform(0.0, 900.0, (L, K, T)),
        "solar_altitude": rng.uniform(-0.5, 1.4, (L, K, T)),
        "solar_azimuth": rng.uniform(0.0, 2 * np.pi, (L, K, T)),
    }
    f["temperature"][3, 0] = 390.0
    f["temperature"][4] = 390.0
    f = {k: v.astype(np.float32) for k, v in f.items()}
    counts = np.array([4, 2, 0, 3, 2, 1, 4])[:L]
    mask = np.arange(K)[None, :] < counts[:, None]
    params = dict(psi=rng.uniform(0, np.pi, L), R=rng.uniform(5e-5, 2e-4, L),
                  D=np.full(L, 0.028), Ts=np.full(L, 373.0), epsilon=np.full(L, 0.6),
                  alpha=np.full(L, 0.6))
    return f, mask, params


def test_batched_line_rating_equals_jax():
    f, mask, p = plan()
    order = ("psi", "R", "D", "Ts", "epsilon", "alpha")
    with jax.enable_x64(False):
        want = np.asarray(jlr.batched_line_rating(
            {k: jax.numpy.asarray(v) for k, v in f.items()}, jax.numpy.asarray(mask),
            *(p[k] for k in order)))
    got = tlr.batched_line_rating({k: torch.tensor(v) for k, v in f.items()},
                                  torch.tensor(mask), *(p[k] for k in order))
    assert got.dtype == torch.float32 and got.shape == (7, 9)
    got = got.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[2]).all() and np.isnan(got[4]).all()  # no cell; all cells NaN
    assert np.isfinite(got[3]).all()  # the NaN cell is skipped
    ok = ~np.isnan(want)
    assert np.abs(got[ok] - want[ok]).max() <= 1e-5 * np.abs(want[ok]).max()


def test_line_min_skips_nan_cells():
    """The JAX package's case: one cell with Ta > Ts, one normal cell."""
    fields = {"temperature": [[[390.0], [293.0]]], "wnd100m": [[[0.6], [0.6]]],
              "wnd_azimuth": [[[0.0], [0.0]]], "influx_direct": [[[1000.0], [1000.0]]],
              "solar_altitude": [[[1.0], [1.0]]], "solar_azimuth": [[[3.0], [3.0]]],
              "height": [[[100.0], [100.0]]]}
    args = (np.array([np.pi / 2]), np.array([8.8e-5]), np.array([0.028]), np.array([373.0]),
            np.array([0.8]), np.array([0.8]))
    got = tlr.batched_line_rating({k: torch.tensor(v, dtype=torch.float64)
                                   for k, v in fields.items()},
                                  torch.tensor([[True, True]]), *args).numpy()
    want = np.asarray(jlr.batched_line_rating(
        {k: jax.numpy.asarray(v) for k, v in fields.items()},
        jax.numpy.asarray([[True, True]]), *args))
    assert np.isfinite(got[0, 0]) and got[0, 0] > 0
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("T", [1, 24, 300])
def test_shift_and_aggregate_is_np_roll(T):
    rng = np.random.default_rng(T)
    B, P, n_plants = 6, 15, 4
    runoff = rng.uniform(0.0, 1.0, (B, T)).astype(np.float32)
    plant = rng.integers(0, n_plants, P)
    plant[:n_plants] = np.arange(n_plants)
    basin = rng.integers(0, B, P)
    shift = rng.integers(0, 2 * T + 3, P)
    shift[0] = 0
    rolled = np.zeros((n_plants, T), np.float32)
    for p, b, n in zip(plant, basin, shift):
        rolled[p] += np.roll(runoff[b], n)
    with jax.enable_x64(False):
        want = np.asarray(jhydro.shift_and_aggregate(
            jax.numpy.asarray(runoff), jax.numpy.asarray(plant, "int32"),
            jax.numpy.asarray(basin, "int32"), jax.numpy.asarray(shift, "int32"), n_plants))
    got = thydro.shift_and_aggregate(torch.tensor(runoff), plant, basin, shift, n_plants)
    assert got.shape == (n_plants, T)
    np.testing.assert_allclose(got.numpy(), rolled, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_travel_hours_equals_jax():
    dist = pd.Series([0.0, 120.5, 300.0, 37.2, 999.9], index=[11, 12, 13, 14, 15])
    for flowspeed in (0.5, 1, 2.7):
        want = jhydro.travel_hours(dist, 12, [12, 13, 15, 14], flowspeed)
        np.testing.assert_array_equal(thydro.travel_hours(dist, 12, [12, 13, 15, 14],
                                                          flowspeed), want)
        np.testing.assert_array_equal(thydro.travel_hours(dist.to_dict(), 12, [12, 13, 15, 14],
                                                          flowspeed), want)


def test_cutout_hydro_and_line_rating_name_the_gis_slice():
    """The GIS slice wired both: basins and lines now convert."""
    from atlite_tpu_torch.gis.geometry import LineString, box

    c = Cutout(device="cpu", module="synthetic", x=slice(-1, 0), y=slice(50, 51),
               time="2013-01-01").prepare()
    basins = {"HYBAS_ID": [1, 2], "NEXT_DOWN": [0, 1], "DIST_MAIN": [10.0, 40.0],
              "geometry": [box(-1.1, 49.9, -0.5, 51.1), box(-0.5, 49.9, 0.1, 51.1)]}
    inflow = c.hydro(plants={"lon": [-0.8], "lat": [50.5]}, hydrobasins=basins,
                     aggregate_time=None)
    assert inflow.dims == ("plant", "time") and inflow.values.shape == (1, 24)
    assert np.isfinite(inflow.values).all() and inflow.values.max() > 0
    rating = c.line_rating(shapes=[LineString([(-0.9, 50.2), (-0.1, 50.8)])],
                           line_resistance=1e-4)
    assert rating.dims == ("name", "time") and rating.values.shape == (1, 24)
    assert (rating.values > 0).all()
    assert c.line_rating(shapes=[], line_resistance=1e-4).values.shape == (0, 24)
