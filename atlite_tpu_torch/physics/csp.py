"""Concentrated solar power (counterpart of ``atlite_tpu/physics/csp.py``):
direct normal irradiance with the low-sun floor, and the field efficiency
looked up in the installation's (altitude, azimuth) table by bilinear
interpolation, NaN outside the table's hull (zero output after the
converter's fill).
"""

from __future__ import annotations

import math

import torch


def calculate_dni(influx_direct, altitude, altitude_threshold=3.75):
    """DNI on the sun-normal plane, the altitude floored at
    ``altitude_threshold`` degrees against the 1/sin blow-up.  The sun at
    or below the horizon is first set to NaN and then floored as well
    (NaN > floor is false), as in the reference; the efficiency table's
    hull zeroes those hours."""
    thr = math.radians(altitude_threshold)
    alt = torch.where(altitude > 0, altitude, torch.nan)
    alt = torch.where(alt > thr, alt, thr)
    return influx_direct / torch.sin(alt)


def interp2d(xgrid, ygrid, table, xq, yq):
    """Bilinear interpolation of ``table`` (len(xgrid), len(ygrid)) at the
    query points (xq, yq) on ascending grids: the cell is found by
    ``searchsorted`` and its four corners gathered; NaN outside the hull
    (and wherever a corner the weights touch is NaN)."""
    nx, ny = xgrid.shape[0], ygrid.shape[0]
    ix = torch.clamp(torch.searchsorted(xgrid, xq.contiguous(), right=True) - 1, 0, nx - 2)
    iy = torch.clamp(torch.searchsorted(ygrid, yq.contiguous(), right=True) - 1, 0, ny - 2)
    x0, x1 = xgrid[ix], xgrid[ix + 1]
    y0, y1 = ygrid[iy], ygrid[iy + 1]
    wx = (xq - x0) / (x1 - x0)
    wy = (yq - y0) / (y1 - y0)
    flat = table.reshape(-1)
    at = lambda i, j: flat[i * ny + j]  # noqa: E731
    val = (at(ix, iy) * (1 - wx) * (1 - wy) + at(ix + 1, iy) * wx * (1 - wy)
           + at(ix, iy + 1) * (1 - wx) * wy + at(ix + 1, iy + 1) * wx * wy)
    oob = (xq < xgrid[0]) | (xq > xgrid[-1]) | (yq < ygrid[0]) | (yq > ygrid[-1])
    return torch.where(oob, torch.nan, val)


def csp_specific_generation(fields, solar_position, installation):
    """Thermal output per reference capacity: efficiency times the
    technology's irradiance over the reference irradiance, clipped at 1,
    NaN set to 0."""
    tech = installation["technology"]
    if tech == "parabolic trough":
        irradiation = fields["influx_direct"]
    elif tech == "solar tower":
        irradiation = calculate_dni(fields["influx_direct"], solar_position["altitude"])
    else:
        raise ValueError(f'Unknown CSP technology option "{tech}".')

    alt = solar_position["altitude"]

    def put(a):
        return torch.as_tensor(a, dtype=alt.dtype, device=alt.device)

    eff = interp2d(put(installation["efficiency_altitude"]),
                   put(installation["efficiency_azimuth"]),
                   put(installation["efficiency_table"]),
                   alt, solar_position["azimuth"])
    da = torch.clamp(eff * irradiation / installation["r_irradiance"], max=1.0)
    return torch.nan_to_num(da, nan=0.0)
