"""Reference of ``Cutout.solar_thermal``: atlite's collector model on the
'simple' tilted total irradiation of fixed panels.

The irradiation ``G`` is ``physics.pv_cf``'s, written out here for fixed
panels: stored solar angles, the 'simple' transposition of the direct,
diffuse and ground-reflected parts (each NaN taken as 0), the 1 degree
low-sun cut.  The collector gives ``G * (c0 - c1 * (t_store + 273.15 -
T) / G)``, ``t_store`` in degC and the temperature ``T`` in K, with
output at or below 0 set to 0.  Where ``G`` is 0, atlite's loss ratio is
infinite and its output NaN, then 0 by that rule; here the ratio is
taken as 0, which gives the same 0.  Departures from atlite: only fixed
panels, and the 'simple' trigonometric and clear-sky models (the
clear-sky model is unused where a cutout stores direct and diffuse
influx, as ERA5's does); anything else raises.
"""

from __future__ import annotations

import math

import torch

from h100_bench.reference import physics

FIELDS = ("influx_toa", "influx_direct", "influx_diffuse", "albedo", "solar_altitude",
          "solar_azimuth", "temperature")
DAILY = False
KELVIN = 273.15
# relative L2 gap of a per-unit series; set from the readings in PERF.md
# section 6
LIMIT = 1e-4


def fields(kwargs):
    """The fields a call with ``kwargs`` reads."""
    return FIELDS


def tilted_total(f, lat, orientation):
    """(T, C) total irradiation on fixed panels of ``orientation`` (a
    slope and azimuth in degrees, or "latitude_optimal"), W/m^2."""
    alt, az = f["solar_altitude"], f["solar_azimuth"]
    sin_alt = torch.sin(alt)
    cos_alt = torch.sqrt(torch.clamp(1.0 - sin_alt * sin_alt, min=0.0))
    slope, panel_az = physics._panel_orientation(orientation, lat)
    cos_slope = torch.cos(slope)
    cosinc = torch.clamp(torch.sin(slope) * cos_alt * torch.cos(az - panel_az)
                         + cos_slope * sin_alt, min=0.0)
    toa = f["influx_toa"]
    direct = torch.minimum(torch.clamp(f["influx_direct"], min=0.0), toa)
    diffuse = torch.minimum(torch.clamp(f["influx_diffuse"], min=0.0), toa - direct)
    influx = direct + diffuse
    direct_t = torch.nan_to_num(cosinc / sin_alt * direct, nan=0.0)
    diffuse_t = torch.nan_to_num((1.0 + cos_slope) / 2.0 * diffuse, nan=0.0)
    ground_t = torch.nan_to_num(f["albedo"] * influx * ((1.0 - cos_slope) / 2.0), nan=0.0)
    total = direct_t + diffuse_t + ground_t
    low = (sin_alt < math.sin(math.radians(1.0))) | (influx <= 0.01)
    return torch.where(low, torch.zeros_like(total), total)


def cell_values(f, lat, kwargs, hours=None):
    del hours
    for key in ("trigon_model", "clearsky_model"):
        if kwargs.get(key, "simple") != "simple":
            raise ValueError(f"the reference takes {key}='simple' only")
    if kwargs.get("tracking") is not None:
        raise ValueError("the reference takes fixed panels only")
    g = tilted_total(f, lat, kwargs.get("orientation", {"slope": 45.0, "azimuth": 180.0}))
    loss = (kwargs.get("t_store", 80.0) + KELVIN - f["temperature"]) / torch.where(
        g != 0, g, torch.ones_like(g))
    ratio = torch.where(g != 0, loss, torch.zeros_like(g))
    out = g * (kwargs.get("c0", 0.8) - kwargs.get("c1", 3.0) * ratio)
    return torch.where(out > 0.0, out, torch.zeros_like(out))
