"""Concentrated solar power: the port against the JAX package, on the
CPU, JAX with x64 off.

Covered: ``calculate_dni`` around its floor and below the horizon; the
port's one gather-based bilinear ``interp2d`` against both JAX forms
(``interp2d_uniform_hats``, which JAX takes on uniform finite tables, and
``interp2d_regular``), inside and outside the hull, on a non-uniform grid
and with NaN entries; ``csp`` for the solar tower, the parabolic trough,
the lossless installation with its ``technology=`` override, the tower's
table as a trough, and a table whose altitude range leaves daytime hours
outside the hull; resident, with a matrix, streamed raw and int16.

Tolerance: 1e-5 * max|JAX| in absolute terms, NaN masks identical (the
hat form builds its weights from |x - x_i| / dx and sits ~4e-6 of the max
from the gather form).
"""

import math
import warnings

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import atlite_tpu
from atlite_tpu.physics import csp as jcsp
from atlite_tpu_torch import Cutout
from atlite_tpu_torch.physics import csp as tcsp

torch.set_num_threads(1)

KW = dict(module="synthetic", x=slice(-4, 1.5), y=slice(56, 62),
          time=slice("2013-06-01", "2013-06-03"))
REL = 1e-5


@pytest.fixture(scope="module")
def pair():
    with jax.enable_x64(False):
        jc = atlite_tpu.Cutout(None, **KW).prepare(features=["influx"])
    tc = Cutout(device="cpu", **KW).prepare(features=["influx"])
    C = tc.shape[0] * tc.shape[1]
    return jc, tc, sp.random(4, C, density=0.3, random_state=4, format="csr",
                             dtype=np.float32)


def both(pair, **kw):
    jc, tc = pair[:2]
    with jax.enable_x64(False), warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        want = jc.csp(**kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        got = tc.csp(**kw)
    return got, want


def assert_close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    if ok.any():
        err = np.abs(got[ok] - want[ok]).max()
        assert err <= rel * np.abs(want[ok]).max(), err


def f32(a):
    return np.asarray(a, dtype=np.float32)


def test_calculate_dni_equals_jax():
    alt = f32([-0.2, 0.0, 1e-4, math.radians(3.75), math.radians(3.76), 0.5, 1.5])
    direct = f32([100.0, 200.0, 50.0, 300.0, 300.0, 700.0, 900.0])
    with jax.enable_x64(False):
        want = np.asarray(jcsp.calculate_dni(direct, alt))
    got = tcsp.calculate_dni(torch.tensor(direct), torch.tensor(alt)).numpy()
    # the sun at or below the horizon is floored too (NaN > floor is
    # false), as in the reference; the table's hull zeroes those hours
    np.testing.assert_allclose(got[:3], direct[:3] / np.sin(np.float32(math.radians(3.75))),
                               rtol=1e-6)
    assert_close(got, want)


def queries(rng, n=400):
    alt = rng.uniform(-0.2, 1.7, n)
    azi = rng.uniform(-0.1, 2 * np.pi + 0.1, n)
    alt[:4] = [0.0, np.radians(90.0), np.radians(45.0), np.radians(5.0)]  # on knots
    azi[:4] = [0.0, 2 * np.pi, np.radians(180.0), np.radians(7.5)]
    return f32(alt), f32(azi)


@pytest.mark.parametrize("jax_form", ["hats", "regular"])
def test_interp2d_meets_both_jax_forms(jax_form):
    rng = np.random.default_rng(0)
    xg, yg = np.radians(np.arange(0.0, 91.0, 5.0)), np.radians(np.arange(0.0, 361.0, 5.0))
    table = rng.uniform(0.0, 1.0, (len(xg), len(yg)))
    xq, yq = queries(rng)
    fn = jcsp.interp2d_uniform_hats if jax_form == "hats" else jcsp.interp2d_regular
    with jax.enable_x64(False):
        # the queries as float32 device arrays, as the converter passes
        # them (numpy queries would test the hull in float64)
        args = (xg, yg, table) if jax_form == "hats" else tuple(map(f32, (xg, yg, table)))
        want = np.asarray(fn(*args, jax.numpy.asarray(xq), jax.numpy.asarray(yq)))
    got = tcsp.interp2d(*(torch.tensor(f32(a)) for a in (xg, yg, table)),
                        torch.tensor(xq), torch.tensor(yq)).numpy()
    assert np.isnan(want).any() and (~np.isnan(want)).any()  # out of the hull
    assert_close(got, want)


def test_interp2d_nonuniform_and_nan_table():
    """JAX takes its gather form here; a NaN entry reaches every query
    whose cell has it as a corner."""
    rng = np.random.default_rng(1)
    xg, yg = f32(np.radians([0.0, 10.0, 30.0, 90.0])), f32(np.radians([0.0, 90.0, 270.0, 360.0]))
    table = f32(rng.uniform(0.0, 1.0, (4, 4)))
    table[1, 2] = np.nan
    xq, yq = queries(rng)
    with jax.enable_x64(False):
        want = np.asarray(jcsp.interp2d_regular(xg, yg, table, xq, yq))
    got = tcsp.interp2d(*(torch.tensor(a) for a in (xg, yg, table, xq, yq))).numpy()
    assert_close(got, want)


INSTALLATIONS = {
    "tower": dict(installation="SAM_solar_tower"),
    "trough": dict(installation="SAM_parabolic_trough"),
    "lossless_tower": dict(installation="lossless_installation", technology="solar tower"),
    "tower_as_trough": dict(installation="SAM_solar_tower", technology="parabolic trough"),
}


@pytest.mark.parametrize("mode", ["resident", "matrix", "streamed", "streamed_matrix",
                                  "int16_matrix"])
@pytest.mark.parametrize("inst", sorted(INSTALLATIONS))
def test_csp_equals_jax(pair, inst, mode):
    kw = dict(INSTALLATIONS[inst], aggregate_time=None)
    if "matrix" in mode:
        kw["matrix"] = pair[2]
    if mode != "resident" and mode != "matrix":
        kw["time_chunk"] = 30
    if mode.startswith("int16"):
        kw["stream_pack"] = "int16"
    got, want = both(pair, **kw)
    assert got.dims == want.dims and got.attrs == want.attrs and got.name == want.name
    assert_close(got.values, want.values)
    if mode == "resident":
        assert got.attrs["units"] == "kWh/kW_ref"
        v = got.values
        assert (v >= 0).all() and (v <= 1.0).all() and v.max() > 0
        assert (v[pair[1].data["solar_altitude"] <= 0] == 0).all()


def test_lossless_bounds_the_tower_and_needs_a_technology(pair):
    tc = pair[1]
    real = tc.csp("SAM_solar_tower", aggregate_time=None).values
    lossless = tc.csp("lossless_installation", technology="solar tower",
                      aggregate_time=None).values
    assert (real <= lossless + 1e-6).all()
    # the file's technology is the string "None"
    with pytest.raises(ValueError, match="None"):
        tc.csp("lossless_installation", aggregate_time=None)
    with pytest.raises(ValueError, match="fresnel"):
        tc.csp("SAM_solar_tower", technology="fresnel", aggregate_time=None)


def test_altitude_outside_the_table_is_zero(pair):
    """A table over 10-50 deg of altitude: June noon at 56-62 N climbs
    above it, so daytime hours fall outside the hull (NaN, then 0)."""
    inst = {"technology": "parabolic trough", "r_irradiance": 950,
            "efficiency_altitude": np.radians([10.0, 30.0, 50.0]),
            "efficiency_azimuth": np.radians([0.0, 180.0, 360.0]),
            "efficiency_table": np.array([[0.2, 0.5, 0.2], [0.4, 0.8, 0.4],
                                          [0.5, 0.9, 0.5]])}
    got, want = both(pair, installation=inst, aggregate_time=None)
    assert_close(got.values, want.values)
    alt = pair[1].data["solar_altitude"]
    direct = pair[1].data["influx_direct"]
    above = (alt > np.radians(50.5)) & (direct > 0)
    inside = (alt > np.radians(10.5)) & (alt < np.radians(49.5)) & (direct > 1)
    assert above.any() and inside.any()
    assert (got.values[above] == 0).all() and (got.values[inside] > 0).all()
