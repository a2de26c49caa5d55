"""The PyTorch port's physics modules against the JAX package's, on the
same numpy inputs, in float32 (JAX with x64 off, as it runs on its chip).

Tolerances: elementwise float32 chains whose operations are the same in
both packages agree to a few ulp, so values of order 1 are held at
atol 1e-6 / rtol 1e-6 and irradiances (order 1000 W/m^2) at rtol 1e-5.
The solar-position broadcast divides by cos(altitude) and takes
sqrt(1 - cos^2): there both packages are ~1.6e-5 from a float64
evaluation, so its (sin, cos) pairs are held at atol 5e-5, and its
angles, which go through arcsin/arccos near +-1, at atol 1e-3.
"""

import math

import jax
import numpy as np
import pytest
import torch

from atlite_tpu import reference_impl
from atlite_tpu.physics import irradiation as jirr
from atlite_tpu.physics import orientation as jori
from atlite_tpu.physics import pv as jpv
from atlite_tpu.physics import solar as jsolar
from atlite_tpu.physics import wind as jwind
from atlite_tpu_torch import build_inputs
from atlite_tpu_torch.physics import irradiation as tirr
from atlite_tpu_torch.physics import orientation as tori
from atlite_tpu_torch.physics import pv as tpv
from atlite_tpu_torch.physics import solar as tsolar
from atlite_tpu_torch.physics import wind as twind

torch.set_num_threads(1)

HULD = dict(model="huld", c_temp_amb=1.0, c_temp_irrad=0.035, r_tmod=298.0,
            r_irradiance=1000.0, k_1=-0.017162, k_2=-0.040289, k_3=-0.004681,
            k_4=0.000148, k_5=0.000169, k_6=0.000005, inverter_efficiency=0.9)
BOFINGER = dict(model="bofinger", threshold=1.0, A=0.0659164166836276,
                B=-4.44310393547042e-06, C=0.0122044905275824, D=-0.0035,
                NOCT=318.0, Tstd=298.0, Tamb=293.0, Intc=800.0, ta=0.9,
                inverter_efficiency=0.9)
LATS = np.array([-60, -50, -37.3, -25, -10, 0, 10, 25, 37.3, 50, 55, 60],
                dtype=np.float32)


def f32(a):
    return np.asarray(a, dtype=np.float32)


def tt(a):
    return torch.tensor(f32(a))


def jax_f32(fn, *args, **kwargs):
    """fn run by JAX with x64 off; array leaves returned as numpy."""
    with jax.enable_x64(False):
        return jax.tree.map(np.asarray, fn(*args, **kwargs))


def close(got, want, rtol=1e-6, atol=1e-6):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def sky(T=12, Y=5, X=7, seed=0):
    """Solar angles, irradiances and temperatures on a (T, Y, X) grid."""
    rng = np.random.default_rng(seed)
    alt = rng.uniform(-0.3, 1.4, (T, Y, X))
    alt[0, 0, :3] = [0.0, math.radians(1.0), -0.01]  # around the low-sun cut
    toa = 1361.0 * np.clip(np.sin(alt), 0.0, None)
    total = rng.uniform(0.2, 0.9, alt.shape) * toa
    direct = rng.uniform(-0.1, 1.1, alt.shape) * total
    return {
        "solar_altitude": f32(alt),
        "solar_azimuth": f32(rng.uniform(0.0, 2 * np.pi, alt.shape)),
        "influx_toa": f32(toa),
        "influx": f32(total + rng.uniform(-5, 5, alt.shape)),
        "influx_direct": f32(direct),
        "influx_diffuse": f32(total - direct + rng.uniform(-5, 5, alt.shape)),
        "albedo": f32(rng.uniform(0.05, 0.4, alt.shape)),
        "outflux": f32(rng.uniform(0.0, 200.0, alt.shape)),
        "temperature": f32(rng.uniform(250.0, 310.0, alt.shape)),
        "humidity": f32(rng.uniform(0.0, 1.0, alt.shape)),
    }


# ---- solar.py

def test_solar_position():
    rng = np.random.default_rng(1)
    dec, h0 = f32(rng.uniform(-0.41, 0.41, 9)), f32(rng.uniform(-np.pi, np.pi, 9))
    lon, lat = f32(np.linspace(-12, 18, 7)), LATS
    want = jax_f32(jsolar.solar_position, dec, h0, lon, lat)
    got = tsolar.solar_position(tt(dec), tt(h0), tt(lon), tt(lat))
    assert set(got) == set(want)
    for k in ("sin_altitude", "cos_altitude", "sin_azimuth", "cos_azimuth"):
        close(got[k], want[k], atol=5e-5)
    for k in ("altitude", "azimuth"):
        close(got[k], want[k], atol=1e-3)


def test_solar_position_trig():
    fields = sky()
    sp = {"altitude": fields["solar_altitude"], "azimuth": fields["solar_azimuth"]}
    want = jax_f32(jsolar.solar_position_trig, sp)
    got = tsolar.solar_position_trig({k: tt(v) for k, v in sp.items()})
    for k in want:
        close(got[k], want[k])


def test_solar_position_numpy_is_the_same_function():
    rng = np.random.default_rng(2)
    dec, h0 = rng.uniform(-0.41, 0.41, 5), rng.uniform(-np.pi, np.pi, 5)
    lon, lat = np.linspace(-12, 18, 4), np.linspace(35, 60, 3)
    want = jsolar.solar_position_numpy(dec, h0, lon, lat)
    got = tsolar.solar_position_numpy(dec, h0, lon, lat)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# ---- wind.py

CURVE_V = f32([0.0, 3.0, 3.0, 5.0, 10.0, 12.0, 25.0, 25.0, 26.0])
CURVE_P = f32([0.0, 0.0, 0.05, 0.2, 0.8, 1.0, 1.0, 0.0, 0.0])
QUERIES = f32([-1.0, 0.0, 2.9, 3.0, 3.5, 5.0, 7.3, 10.0, 11.99, 12.0, 24.99,
               25.0, 25.5, 26.0, 30.0, np.nan, np.inf, -np.inf])


@pytest.mark.parametrize("P", [1.0, 3.0])
def test_power_curve_edges(P):
    """Below the range, above it, on knots, at the duplicated cut-in and
    cut-out knots (post-jump value), and NaN."""
    pw = CURVE_P * P
    want = jax_f32(jwind.power_curve, QUERIES, CURVE_V, pw, P)
    got = twind.power_curve(tt(QUERIES), tt(CURVE_V), tt(pw), P)
    close(got, want)
    finite = np.isfinite(QUERIES)
    close(got[torch.as_tensor(finite)],
          np.interp(QUERIES[finite], CURVE_V, CURVE_P), atol=1e-6)
    # [left, right): on a duplicated knot the post-jump segment wins
    assert got[3] == pytest.approx(0.05) and got[11] == 0.0
    assert torch.isnan(got[15])


def test_power_curve_field():
    rng = np.random.default_rng(3)
    ws = f32(rng.uniform(-2.0, 30.0, (6, 5, 4)))
    V = f32(np.arange(0.0, 26.0, 0.5))
    P = f32(np.clip((V**3 - 27.0) / (12.0**3 - 27.0), 0, 1))
    P[V >= 25.0] = 0.0
    close(twind.power_curve(tt(ws), tt(V), tt(P), 1.0),
          jax_f32(jwind.power_curve, ws, V, P, 1.0))


def test_simplify_power_curve():
    V = np.arange(0.0, 26.0, 0.5)
    P = np.clip((V**3 - 27.0) / (12.0**3 - 27.0), 0, 1)
    P[V >= 25.0] = 0.0
    for v, p in ((V, P), (CURVE_V, CURVE_P)):
        gv, gp = twind.simplify_power_curve(v, p)
        wv, wp = jwind.simplify_power_curve(v, p)
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gp, wp)
    # the simplified curve gives the same value for every query
    sv, sp_ = twind.simplify_power_curve(V, P)
    q = tt(np.linspace(-1, 27, 113))
    close(twind.power_curve(q, tt(sv), tt(sp_), 1.0),
          twind.power_curve(q, tt(V), tt(P), 1.0), atol=1e-6)


@pytest.mark.parametrize("method", ["logarithmic", "power"])
def test_extrapolate_wind_speed(method):
    rng = np.random.default_rng(4)
    shape = (5, 4, 3)
    fields = {"wnd100m": f32(rng.uniform(0.5, 25.0, shape)),
              "roughness": f32(rng.uniform(2e-4, 1.2, shape)),
              "wnd_shear_exp": f32(rng.uniform(0.05, 0.4, shape))}
    fields["wnd100m"][0, 0, 0] = np.nan
    want = jax_f32(jwind.extrapolate_wind_speed, fields, 80.0, method=method)
    got = twind.extrapolate_wind_speed({k: tt(v) for k, v in fields.items()}, 80.0,
                                       method=method)
    close(got, want, rtol=2e-6)
    assert torch.isnan(got[0, 0, 0])


def test_extrapolate_fast_lane_and_heights():
    w = tt(np.ones((2, 2, 2)))
    assert twind.extrapolate_wind_speed({"wnd80m": w}, 80) is w
    assert twind.closest_wind_height([10, 100], 80) == jwind.closest_wind_height([10, 100], 80)
    assert twind.wind_speed_heights({"wnd10m": 0, "wnd100m": 0, "roughness": 0}) == [10, 100]
    with pytest.raises(RuntimeError):
        twind.extrapolate_wind_speed({"wnd100m": w}, 80)
    with pytest.raises(ValueError):
        twind.extrapolate_wind_speed({"wnd100m": w, "roughness": w}, 80, method="cubic")


# ---- orientation.py

@pytest.mark.parametrize("spec", [{"kind": "latitude_optimal"},
                                  {"kind": "constant", "slope": 30.0, "azimuth": 180.0},
                                  {"kind": "latitude", "azimuth": 180.0}])
def test_orientation_fields(spec):
    want = jax_f32(jori.orientation_fields, spec, LATS)
    got = tori.orientation_fields(spec, tt(LATS))
    for g, w in zip(got, want):
        close(torch.as_tensor(g, dtype=torch.float32), np.asarray(w, np.float32),
              rtol=0, atol=0)


def test_latitude_optimal_breakpoints_in_float32():
    """At exactly 25 and 50 deg float32 takes the lower branch, as the JAX
    package does with x64 off (with x64 on, 50 deg takes the 40 deg one)."""
    slope, _ = tori.orientation_fields({"kind": "latitude_optimal"}, tt([25.0, 50.0]))
    a = torch.deg2rad(tt([25.0, 50.0]))
    assert slope[0, 0, 0] == 0.87 * a[0]
    assert slope[0, 1, 0] == 0.76 * a[1] + math.radians(0.31)
    assert slope[0, 1, 0] != np.float32(math.radians(40.0))


def test_get_orientation():
    for args in (("latitude_optimal",), ("constant",), ("latitude",),
                 ({"name": "constant", "slope": 20, "azimuth": 90},)):
        assert tori.get_orientation(*args) == jori.get_orientation(*args)
    with pytest.raises(ValueError):
        tori.get_orientation("sideways")


@pytest.mark.parametrize("with_pairs", [False, True])
def test_surface_orientation(with_pairs):
    fields = sky()
    sp = {"altitude": fields["solar_altitude"], "azimuth": fields["solar_azimuth"]}
    if with_pairs:
        sp = jax_f32(jsolar.solar_position_trig, sp)
    lat = LATS[:5]
    want = jax_f32(jori.surface_orientation, sp, lat, {"kind": "latitude_optimal"}, None)
    got = tori.surface_orientation({k: tt(v) for k, v in sp.items()}, tt(lat),
                                   {"kind": "latitude_optimal"}, None)
    for k in ("cosincidence", "slope", "azimuth"):
        close(got[k], want[k])
    assert got["tracking"] is None


def test_surface_orientation_tracking_not_ported():
    """Named when tracking raised; every tracking mode is ported now and
    matches the JAX package on random sky angles (NaN masks identical),
    and an unknown mode still raises."""
    fields = sky(seed=3)
    sp = {"altitude": fields["solar_altitude"], "azimuth": fields["solar_azimuth"]}
    lat = LATS[:5]
    spec = {"kind": "constant", "slope": 30.0, "azimuth": 180.0}
    for tracking in ("horizontal", "tilted_horizontal", "vertical", "dual"):
        want = jax_f32(jori.surface_orientation, sp, lat, spec, tracking)
        got = tori.surface_orientation({k: tt(v) for k, v in sp.items()}, tt(lat), spec,
                                       tracking)
        for k in ("cosincidence", "slope", "azimuth"):
            g = torch.broadcast_to(torch.as_tensor(got[k]), fields["solar_altitude"].shape)
            w = np.broadcast_to(want[k], fields["solar_altitude"].shape)
            np.testing.assert_array_equal(torch.isnan(g).numpy(), np.isnan(w), err_msg=k)
            close(torch.nan_to_num(g), np.nan_to_num(w), atol=2e-6)
        assert got["tracking"] == tracking
    with pytest.raises(AssertionError):
        tori.surface_orientation(sp, tt([45.0]), {"kind": "latitude_optimal"}, "spin")


# ---- irradiation.py

@pytest.mark.parametrize("model", ["simple", "enhanced"])
def test_diffuse_horizontal_fraction(model):
    rng = np.random.default_rng(5)
    k = f32(np.concatenate([[0.0, 0.3, 0.78, np.nan], rng.uniform(-0.1, 1.2, 60)]))
    sin_alt = f32(rng.uniform(-0.2, 1.0, k.shape))
    temp, rh = f32(rng.uniform(250, 310, k.shape)), f32(rng.uniform(0, 1, k.shape))
    want = jax_f32(jirr.diffuse_horizontal_fraction, k, sin_alt, temp, rh, model)
    got = tirr.diffuse_horizontal_fraction(tt(k), tt(sin_alt), tt(temp), tt(rh), model)
    close(got, want)


@pytest.mark.parametrize("branch", ["influx", "direct_diffuse"])
@pytest.mark.parametrize("albedo", ["albedo", "outflux"])
def test_tilted_irradiation(branch, albedo):
    fields = sky(seed=6)
    drop = {"influx": ("influx_direct", "influx_diffuse"),
            "direct_diffuse": ("influx",)}[branch]
    drop += ("outflux",) if albedo == "albedo" else ("albedo",)
    fields = {k: v for k, v in fields.items() if k not in drop}
    sp = {"altitude": fields["solar_altitude"], "azimuth": fields["solar_azimuth"]}
    lat = LATS[:5]
    spec = {"kind": "latitude_optimal"}

    def jax_chain(fields, sp):
        surf = jori.surface_orientation(sp, lat, spec, None)
        return jirr.tilted_irradiation(fields, sp, surf, clearsky_model=None)

    want = jax_f32(jax_chain, fields, sp)
    tf = {k: tt(v) for k, v in fields.items()}
    tsp = {k: tt(v) for k, v in sp.items()}
    surf = tori.surface_orientation(tsp, tt(lat), spec, None)
    got = tirr.tilted_irradiation(tf, tsp, surf, clearsky_model=None)
    close(got, want, rtol=1e-5, atol=1e-4)
    # the cut is strict and in sin-space: 0 and -0.01 rad are cut, an
    # altitude of exactly 1 deg is not
    assert got[0, 0, 0] == 0 and got[0, 0, 2] == 0 and got[0, 0, 1] != 0


def test_tilted_irradiation_hay_davies_not_ported():
    """Named when Hay-Davies raised; it is ported now and matches the JAX
    package for every irradiation kind."""
    fields = sky()
    sp = {"altitude": fields["solar_altitude"], "azimuth": fields["solar_azimuth"]}
    lat = LATS[:5]
    spec = {"kind": "latitude_optimal"}
    f = {k: tt(v) for k, v in fields.items()}
    tsp = {k: tt(v) for k, v in sp.items()}
    surf = tori.surface_orientation(tsp, tt(lat), spec)
    for kind in ("total", "direct", "diffuse", "ground"):
        def jax_chain(fields, sp):
            surf = jori.surface_orientation(sp, lat, spec, None)
            return jirr.tilted_irradiation(fields, sp, surf, trigon_model="hay_davies",
                                           clearsky_model=None, irradiation=kind)

        want = jax_f32(jax_chain, fields, sp)
        got = tirr.tilted_irradiation(f, tsp, surf, trigon_model="hay_davies",
                                      clearsky_model=None, irradiation=kind)
        close(got, want, rtol=1e-5, atol=1e-4)


# ---- pv.py

@pytest.mark.parametrize("panel", [HULD, BOFINGER], ids=["huld", "bofinger"])
def test_solar_panel_power(panel):
    rng = np.random.default_rng(7)
    irr = f32(np.concatenate([[0.0, 0.5, 1.0, 1000.0], rng.uniform(0.0, 1100.0, 60)]))
    temp = f32(rng.uniform(250.0, 310.0, irr.shape))
    want = jax_f32(jpv.solar_panel_power, irr, temp, panel)
    got = tpv.solar_panel_power(tt(irr), tt(temp), panel)
    close(got, want, rtol=2e-6, atol=1e-6)
    with pytest.raises(AssertionError):
        tpv.solar_panel_power(tt(irr), tt(temp), {**panel, "model": "perfect"})


# ---- the chains in float64 against the JAX package's numpy oracle

@pytest.mark.parametrize("branch", ["wind", "pv"])
def test_float64_chain_matches_numpy_oracle(branch):
    """The port's modules composed as the step composes them, in float64,
    against ``atlite_tpu.reference_impl`` (an independent float64 numpy
    implementation); float64 rounding differences only: atol 1e-9."""
    fields, _, _, lat, V, POWn, _ = build_inputs(30, 9, 11, 2)
    f = {k: v.astype(np.float64) for k, v in fields.items() if v.ndim == 3}
    tf = {k: torch.tensor(v) for k, v in f.items()}
    if branch == "wind":
        V64, P64 = V.astype(np.float64), POWn.astype(np.float64)
        got = twind.power_curve(twind.extrapolate_wind_speed(tf, 80.0),
                                torch.tensor(V64), torch.tensor(P64), 1.0)
        want = reference_impl.wind_cf_numpy(f, V64, P64, 1.0, 80.0)
    else:
        sp = {"altitude": tf["solar_altitude"], "azimuth": tf["solar_azimuth"]}
        lat64 = torch.tensor(lat.astype(np.float64))
        surf = tori.surface_orientation(sp, lat64, {"kind": "latitude_optimal"})
        irr = tirr.tilted_irradiation(tf, sp, surf)
        got = tpv.power_huld(irr, tf["temperature"], HULD)
        want = reference_impl.pv_cf_numpy(f, lat.astype(np.float64), HULD)
    assert np.abs(want).max() > 0.1
    close(got, want, rtol=1e-9, atol=1e-9)
