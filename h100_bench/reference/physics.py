"""Plain reference of what the benchmark's calls compute: wind and PV
capacity factors per cell and hour, and their aggregation to regions.

A frozen copy of the semantics of atlite's converters (hub-height
extrapolation by the log law, the power curve as ``numpy.interp`` with a
cut-out knot, the solar geometry of fixed and horizontally tracking
panels, the 'simple' transposition with the 1 degree low-sun cut, the
Huld panel model) and of its aggregation (a NaN cell poisons only the
regions whose row holds a weight there; per unit: divided by the row's
sum, NaN and zero rows to 0).  Plain ``torch`` in the dtype asked for:
float64 for the reference, bfloat16 for the control.  It reads only the
benchmark's inputs and ``resources.json`` (copies of atlite's turbine
and panel files) and imports nothing of the program.  The methods'
modules beside it (``wind.py``, ``pv.py``) name the fields each reads.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import torch

RESOURCES = json.loads((Path(__file__).resolve().parent / "resources.json").read_text())
DATA_HEIGHT = 100.0  # the cutout's wind speed is at 100 m


def turbine_curve(name, add_cutout_windspeed=True):
    """(V, POW / P, hub height) of a turbine, with atlite's cut-out knot
    (a last knot of 0 power at the largest speed) added where the curve
    lacks one, unless ``add_cutout_windspeed`` is false."""
    t = RESOURCES["turbines"][name]
    V, POW = list(t["V"]), list(t["POW"])
    if add_cutout_windspeed and POW[-1] != 0.0:
        V, POW = V + [max(V)], POW + [0.0]
    P = max(POW)
    return V, [p / P for p in POW], float(t["hub_height"])


def power_curve(ws, V, POWn):
    """interp(ws, V, POWn): below the curve its first value, from its last
    knot on its last value, a knot's segment [V[k], V[k+1]) (so a speed on
    a duplicated cut-out knot takes the value after the jump); NaN stays."""
    out = torch.full_like(ws, POWn[0])
    for k in range(len(V) - 1):
        left, right = V[k], V[k + 1]
        if right == left:
            continue
        slope = (POWn[k + 1] - POWn[k]) / (right - left)
        out = torch.where((ws >= left) & (ws < right), POWn[k] + (ws - left) * slope, out)
    out = torch.where(ws >= V[-1], torch.full_like(ws, POWn[-1]), out)
    return torch.where(torch.isnan(ws), ws, out)


def wind_cf(f, turbine, hub_height=None, add_cutout_windspeed=True):
    """Capacity factor of ``turbine`` from the (T, C) fields ``f``; the
    hub height is the turbine's unless given."""
    V, POWn, hub = turbine_curve(turbine, add_cutout_windspeed)
    hub = hub if hub_height is None else float(hub_height)
    ws = f["wnd100m"]
    if hub != DATA_HEIGHT:
        z0 = f["roughness"]
        ws = ws * (torch.log(hub / z0) / torch.log(DATA_HEIGHT / z0))
    return power_curve(ws, V, POWn)


def _panel_orientation(orientation, lat):
    """(slope, azimuth) in radians: a constant orientation in degrees, or
    atlite's latitude-optimal fit facing the equator; ``lat`` (C,) deg."""
    if orientation == "latitude_optimal":
        a = torch.abs(torch.deg2rad(lat))
        slope = torch.where(a <= math.radians(25.0), 0.87 * a,
                            torch.where(a <= math.radians(50.0), 0.76 * a + math.radians(0.31),
                                        torch.full_like(a, math.radians(40.0))))
        azimuth = torch.where(lat < 0, torch.zeros_like(a), torch.full_like(a, math.pi))
        return slope, azimuth
    return (torch.full_like(lat, math.radians(orientation["slope"])),
            torch.full_like(lat, math.radians(orientation["azimuth"])))


def pv_cf(f, lat, panel, orientation, tracking=None):
    """Specific PV output (kWh/kWp) of ``panel`` from the (T, C) fields
    ``f``; ``lat`` (C,) deg."""
    pc = RESOURCES["panels"][panel]
    alt, az = f["solar_altitude"], f["solar_azimuth"]
    sin_alt = torch.sin(alt)
    cos_alt = torch.sqrt(torch.clamp(1.0 - sin_alt * sin_alt, min=0.0))
    slope, panel_az = _panel_orientation(orientation, lat)
    if tracking is None:
        cos_slope = torch.cos(slope)
        cosinc = torch.sin(slope) * cos_alt * torch.cos(az - panel_az) + cos_slope * sin_alt
    elif tracking == "horizontal":
        rotation = torch.arctan((cos_alt / sin_alt) * torch.sin(az - panel_az))
        surface_slope = torch.abs(rotation)
        surface_az = panel_az + torch.arcsin(torch.sin(rotation) / torch.sin(surface_slope))
        cos_slope = torch.cos(surface_slope)
        cosinc = cos_slope * sin_alt + torch.sin(surface_slope) * cos_alt * torch.cos(az - surface_az)
    else:
        raise ValueError(f"no reference for tracking {tracking!r}")
    cosinc = torch.clamp(cosinc, min=0.0)
    toa = f["influx_toa"]
    direct = torch.minimum(torch.clamp(f["influx_direct"], min=0.0), toa)
    diffuse = torch.minimum(torch.clamp(f["influx_diffuse"], min=0.0), toa - direct)
    influx = direct + diffuse
    direct_t = torch.nan_to_num(cosinc / sin_alt * direct, nan=0.0)
    diffuse_t = torch.nan_to_num((1.0 + cos_slope) / 2.0 * diffuse, nan=0.0)
    ground_t = torch.nan_to_num(f["albedo"] * influx * ((1.0 - cos_slope) / 2.0), nan=0.0)
    total = direct_t + diffuse_t + ground_t
    low = (sin_alt < math.sin(math.radians(1.0))) | (influx <= 0.01)
    irr = torch.where(low, torch.zeros_like(total), total)
    # Huld et al. (2010)
    t_mod = pc["c_temp_amb"] * f["temperature"] + pc["c_temp_irrad"] * irr - pc["r_tmod"]
    g = irr / pc["r_irradiance"]
    log_g = torch.log(torch.where(g > 0, g, torch.full_like(g, math.nan)))
    eff = (1 + pc["k_1"] * log_g + pc["k_2"] * log_g ** 2
           + t_mod * (pc["k_3"] + pc["k_4"] * log_g + pc["k_5"] * log_g ** 2)
           + pc["k_6"] * t_mod ** 2)
    eff = torch.clamp(torch.nan_to_num(eff, nan=0.0), min=0.0)
    return g * eff * pc["inverter_efficiency"]


def aggregate(cf, matrix):
    """(T, C) cell values times the (B, C) matrix, transposed: (T, B); a
    NaN cell makes NaN the regions whose row weighs it."""
    nan = torch.isnan(cf)
    out = torch.where(nan, torch.zeros_like(cf), cf) @ matrix.T
    if nan.any():
        touched = nan.to(cf.dtype) @ (matrix != 0).to(cf.dtype).T
        out = torch.where(touched > 0, torch.full_like(out, math.nan), out)
    return out


def per_unit(series, matrix):
    """(T, B) series divided by each row's weight sum; NaN and rows of no
    weight give 0."""
    cap = matrix.sum(dim=1)
    scaled = series * torch.where(cap != 0, 1.0 / torch.where(cap != 0, cap, 1.0),
                                  torch.zeros_like(cap))
    return torch.nan_to_num(scaled, nan=0.0)


def series(fields, lat, names, values, matrix, dtype, per_unit_=True, block=1024):
    """(T, B) series in ``dtype``, in blocks of ``block`` hours.

    ``fields``: {name: (T, C) float32 tensor}, of which ``names`` are read;
    ``values(f, lat)``: the (T, C) cell values of a block of them; ``lat``:
    (C,) deg; ``matrix``: (B, C) dense tensor; all on one device."""
    m = matrix.to(dtype)
    lat = lat.to(dtype)
    T = fields[names[0]].shape[0]
    out = []
    for t0 in range(0, T, block):
        f = {n: fields[n][t0:t0 + block].to(dtype) for n in names}
        out.append(aggregate(values(f, lat), m))
    s = torch.cat(out)
    return per_unit(s, m) if per_unit_ else s
