"""The full-year gates of BASELINE.md (``tests/test_fullyear.py``) on the
port, on the CPU in float64: a synthetic cutout of 2013 (8760 h, 24 x 32
cells), the pinned annual wind and PV capacity factors, the 365 heat
demand days and their total, runoff normalized to a yearly total, and
twelve monthly means.  The pinned numbers hold at rtol 1e-6, as in the
JAX test; the hourly fields against the float64 oracle
(``atlite_tpu/reference_impl.py``) at the JAX test's tolerances.
``chip_smoke.py`` phase 18 (a) holds the same literals on the card.
"""

import numpy as np
import pytest
import torch

from atlite_tpu import reference_impl as ref
from atlite_tpu_torch import Cutout
from atlite_tpu_torch.resource import get_solarpanelconfig, get_windturbineconfig

torch.set_num_threads(2)

WIND_CF = 0.511356830734     # Vestas_V112_3MW
PV_CF = 0.163772480245       # CSi, latitude_optimal
HEAT_DEMAND = 3.3901346450e6
RUNOFF_TOTAL = 5000.0


@pytest.fixture(scope="module")
def year():
    return Cutout(device="cpu", module="synthetic", x=slice(-4, 3.75), y=slice(50, 55.75),
                  time="2013", dtype="float64").prepare()


def host_fields(cutout):
    return {k: np.asarray(v) for k, v in cutout.data.items()}


def test_year_dimensions(year):
    assert len(year.grid_desc.time) == 8760
    assert year.shape == (24, 32)


def test_year_wind(year):
    turbine = get_windturbineconfig("Vestas_V112_3MW")
    cf = year.wind("Vestas_V112_3MW", aggregate_time=None).values
    oracle = ref.wind_cf_numpy(host_fields(year), turbine["V"], turbine["POW"], turbine["P"],
                               turbine["hub_height"])
    np.testing.assert_allclose(cf, oracle, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(float(cf.mean()), WIND_CF, rtol=1e-6)


def test_year_pv(year):
    cf = year.pv(panel="CSi", orientation="latitude_optimal", aggregate_time=None).values
    oracle = ref.pv_cf_numpy(host_fields(year), year.grid_desc.y, get_solarpanelconfig("CSi"))
    np.testing.assert_allclose(cf, oracle, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(float(cf.mean()), PV_CF, rtol=1e-6)
    assert cf[24 * 172 + 12].mean() > cf[24 * 355 + 12].mean()  # Jun 21 noon > Dec 22 noon


def test_year_heat_demand_days(year):
    hd = year.heat_demand(aggregate_time=None)
    assert hd.sizes["time"] == 365
    vals = hd.values
    assert vals[:30].mean() > vals[170:200].mean()
    np.testing.assert_allclose(vals.sum(), HEAT_DEMAND, rtol=1e-6)


@pytest.mark.parametrize("stats", [{2013: {0: RUNOFF_TOTAL}}, {2013: RUNOFF_TOTAL}],
                         ids=["per_bus", "total"])
def test_year_runoff_normalization(year, stats):
    r = year.runoff(layout=year.uniform_layout(), normalize_using_yearly=stats,
                    aggregate_time=None)
    np.testing.assert_allclose(r.values.sum(), RUNOFF_TOTAL, rtol=1e-9)


def test_year_aggregated_monthly_stats(year):
    cf = year.wind("Vestas_V112_3MW", layout=year.uniform_layout(), per_unit=True,
                   aggregate_time=None)
    months = cf.coords["time"].astype("datetime64[M]")
    monthly = np.array([cf.values[0, months == m].mean() for m in np.unique(months)])
    assert len(monthly) == 12
    assert monthly.max() < 1.0 and monthly.min() > 0.0
