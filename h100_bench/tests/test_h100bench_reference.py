"""The plain reference: hand-checked cases, a frozen float64 case at a
tiny size, and its independence from the program."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from h100_bench.harness import named
from h100_bench.harness.cutout import hours_of, lattice
from h100_bench.harness.weather import Weather
from h100_bench.reference import physics

WIND, PV = named.module("reference", "wind"), named.module("reference", "pv")

F64 = torch.float64


def test_power_curve_is_interp():
    V, POWn, hub = physics.turbine_curve("Vestas_V112_3MW")
    assert hub == 80.0 and V[-2:] == [25.0, 25.0] and POWn[-1] == 0.0
    ws = np.random.default_rng(0).uniform(0, 30, 10_000)
    ws = ws[np.abs(ws - 25.0) > 1e-9]
    got = physics.power_curve(torch.as_tensor(ws), V, POWn).numpy()
    want = np.where(ws >= 25.0, 0.0, np.interp(ws, V[:-1], POWn[:-1]))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)
    # on the cut-out knot: the value after the jump; NaN stays NaN
    edge = physics.power_curve(torch.tensor([25.0, np.nan], dtype=F64), V, POWn)
    assert edge[0] == 0.0 and torch.isnan(edge[1])


def test_log_law():
    f = {"wnd100m": torch.tensor([[8.0]], dtype=F64), "roughness": torch.tensor([[0.03]], dtype=F64)}
    got = physics.wind_cf(f, "NREL_ReferenceTurbine_2020ATB_5.5MW")
    V, POWn, _ = physics.turbine_curve("NREL_ReferenceTurbine_2020ATB_5.5MW")
    ws = 8.0 * np.log(120 / 0.03) / np.log(100 / 0.03)
    assert float(got) == pytest.approx(np.interp(ws, V, POWn), rel=1e-14)


def test_pv_at_zenith():
    """A flat panel under the sun at the zenith, 1000 W/m^2 at 263 K: the
    module sits at the reference temperature, so Huld's efficiency is 1
    and the output the inverter's 0.9."""
    one = torch.ones((1, 1), dtype=F64)
    f = {"influx_toa": 1361 * one, "influx_direct": 800 * one, "influx_diffuse": 200 * one,
         "albedo": 0.2 * one, "solar_altitude": np.pi / 2 * one, "solar_azimuth": np.pi * one,
         "temperature": 263.0 * one}
    got = physics.pv_cf(f, torch.tensor([50.0], dtype=F64), "CSi", {"slope": 0.0, "azimuth": 180.0})
    assert float(got) == pytest.approx(0.9, rel=1e-12)
    # below 1 degree of altitude nothing is produced
    f["solar_altitude"] = np.radians(0.9) * one
    assert float(physics.pv_cf(f, torch.tensor([50.0], dtype=F64), "CSi",
                               {"slope": 35.0, "azimuth": 180.0})) == 0.0


def test_aggregate_nan_rule_and_per_unit():
    cf = torch.tensor([[0.5, np.nan, 1.0]], dtype=F64)
    m = torch.tensor([[1.0, 0.0, 3.0], [0.0, 2.0, 0.0], [0.0, 0.0, 0.0]], dtype=F64)
    out = physics.aggregate(cf, m)
    assert out[0, 0] == 3.5 and torch.isnan(out[0, 1]) and out[0, 2] == 0.0
    assert physics.per_unit(out, m).tolist() == [[3.5 / 4.0, 0.0, 0.0]]


# the reference on the benchmark's weather of seed 20131, 7 x 5 cells,
# 2013-06-01 06:00-11:00, regions of the even cells (weight 1) and of the
# odd ones (0.5), per unit: [(region 0 series, region 1 series)]
FROZEN = [
    ({"method": "wind", "turbine": "Vestas_V112_3MW"},
     [1.0, 1.0, 1.0, 0.997558612155204, 0.6891210602200969, 0.4149873706312661],
     [1.0, 1.0, 1.0, 0.9975600400199823, 0.6891862436807603, 0.4150239159320136]),
    ({"method": "wind", "turbine": "NREL_ReferenceTurbine_2020ATB_5.5MW"},
     [1.0, 1.0, 1.0, 1.0, 0.9996366151608232, 0.6546575607842835],
     [1.0, 1.0, 1.0, 1.0, 0.9996748827127888, 0.6546750876139684]),
    ({"method": "pv", "panel": "CSi", "orientation": {"slope": 35.0, "azimuth": 180.0}},
     [0.0705969498956025, 0.1418993926295873, 0.19953622280172428, 0.27879647011443415,
      0.3411453307134049, 0.28484836831155885],
     [0.07059963288718897, 0.14190367641563711, 0.1995338442745221, 0.27879062172815317,
      0.3411381141766215, 0.2848365128822492]),
    ({"method": "pv", "panel": "CSi", "orientation": {"slope": 35.0, "azimuth": 180.0},
      "tracking": "horizontal"},
     [0.22068078485477316, 0.19918613013033906, 0.21805613395446216, 0.2935034630293283,
      0.3485640833946459, 0.29239979972612173],
     [0.22065534186370334, 0.19916252117533914, 0.2180339751398251, 0.29348270703765655,
      0.3485467860128772, 0.2923857008568085]),
    ({"method": "pv", "panel": "CSi", "orientation": "latitude_optimal"},
     [0.06836832659267453, 0.13505385521267954, 0.1929044537620911, 0.27122062116502177,
      0.33321927382181427, 0.2776571135958293],
     [0.0683708872389419, 0.13505894747152053, 0.19290261615322787, 0.27121515719989175,
      0.33321224570499375, 0.2776451368877899]),
]


@pytest.mark.parametrize("tech, r0, r1", FROZEN, ids=lambda v: str(v)[:40])
def test_frozen_case(tech, r0, r1):
    x, y = lattice(-4.0, -2.5, 0.25, 180), lattice(56.0, 57.0, 0.25, 90)
    t = hours_of("2013-06-01")[6:12]
    w = Weather(x, y, t, 20131, "cpu")
    f = {k: v.reshape(len(t), -1) for k, v in w.fields(WIND.FIELDS + PV.FIELDS)}
    lat = torch.as_tensor(np.repeat(y, len(x)))
    m = torch.zeros(2, len(x) * len(y), dtype=F64)
    m[0, ::2], m[1, 1::2] = 1.0, 0.5
    ref = named.module("reference", tech["method"])
    s = physics.series(f, lat, ref.FIELDS, lambda f, lat: ref.cell_values(f, lat, tech), m, F64,
                       block=4)
    np.testing.assert_allclose(s[:, 0].numpy(), r0, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(s[:, 1].numpy(), r1, rtol=1e-12, atol=1e-15)


def test_reference_imports_nothing_of_the_program():
    from h100_bench.harness.bench import CHECKOUT

    code = ("import sys; sys.path.insert(0, %r); import h100_bench.reference.physics, "
            "h100_bench.harness.check; from h100_bench.harness import named; "
            "[named.module(f, n) for f, n in (('reference', 'wind'), ('reference', 'pv'), "
            "('entries', 'convert'), ('entries', 'step'))]; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'atlite_tpu_torch', 'atlite_tpu', 'jax', 'jaxlib', 'flax'}))" % str(CHECKOUT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
