"""Wind physics (counterpart of ``atlite_tpu/physics/wind.py``).

Hub-height extrapolation (logarithmic and power law) and the power-curve
evaluation, as plain tensor functions.  They are the plain version of the
wind half of ``ops/csrc/megakernel.cu``.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def closest_wind_height(available_heights, to_height):
    """Pick the dataset wind-speed height closest to the target."""
    heights = np.asarray(sorted(available_heights))
    if heights.size == 0:
        raise AssertionError("Wind speed is not in dataset")
    return int(heights[np.argmin(np.abs(heights - to_height))])


def wind_speed_heights(fields):
    """All heights h for which a 'wnd{h}m' variable exists."""
    return [int(m.group(1)) for v in fields
            if (m := re.fullmatch(r"wnd(\d+)m", v))]


def extrapolate_wind_speed(fields, to_height, from_height=None, method="logarithmic"):
    """Extrapolate wind speed to ``to_height``.

    fields: dict with 'wnd{h}m' plus 'roughness' (log law) or
    'wnd_shear_exp' (power law).  Fast lane: if 'wnd{to_height}m' exists it
    is returned unchanged.
    """
    to_name = f"wnd{int(to_height):0d}m"
    if to_name in fields:
        return fields[to_name]

    if from_height is None:
        from_height = closest_wind_height(wind_speed_heights(fields), to_height)
    from_name = f"wnd{int(from_height):0d}m"

    if method == "logarithmic":
        if "roughness" not in fields:
            raise RuntimeError(
                "The logarithmic interpolation method requires surface "
                "roughness (roughness); make sure you choose a compatible "
                "dataset like era5"
            )
        z0 = fields["roughness"]
        # a 0-dim tensor numerator keeps one correctly rounded division
        # (``float / tensor`` in torch multiplies by the reciprocal)
        return fields[from_name] * (
            torch.log(z0.new_tensor(to_height) / z0)
            / torch.log(z0.new_tensor(from_height) / z0)
        )
    if method == "power":
        if "wnd_shear_exp" not in fields:
            raise RuntimeError(
                "The power law interpolation method requires a wind shear "
                "exponent (wnd_shear_exp); make sure you choose a compatible "
                "dataset like era5 and update your cutout"
            )
        return fields[from_name] * torch.pow(to_height / from_height,
                                             fields["wnd_shear_exp"])
    raise ValueError(
        f"Interpolation method must be 'logarithmic' or 'power', but is: {method}"
    )


def simplify_power_curve(V, POW, tol=0.0):
    """Drop interior knots where the curve's slope does not change.

    Removing collinear interior knots leaves np.interp(V, POW) identical
    for every query.  ``tol`` > 0 additionally drops knots whose slope
    change is below tol (approximation).  Duplicate-V knots (cut-in/cut-out
    jumps) are kept.
    """
    V = np.asarray(V, dtype=float)
    POW = np.asarray(POW, dtype=float)
    if len(V) <= 2:
        return V, POW
    dv = np.diff(V)
    with np.errstate(divide="ignore", invalid="ignore"):
        slopes = np.where(dv == 0, np.inf, np.diff(POW) / np.where(dv == 0, 1, dv))
    keep = np.ones(len(V), dtype=bool)
    # interior knot i sits between segments i-1 and i
    slope_change = np.abs(np.diff(slopes))
    keep[1:-1] = ~np.isfinite(slope_change) | (slope_change > tol)
    # never drop knots adjacent to a duplicate-V jump
    dup = dv == 0
    keep[:-1] |= dup
    keep[1:] |= dup
    return V[keep], POW[keep]


def curve_segments(V, POWn):
    """Per-segment (left, right, start value, slope) of a piecewise-linear
    curve; a duplicated knot gives a zero-width segment that no query
    falls in.  The fused kernel is given the same slopes."""
    left, right = V[:-1], V[1:]
    inv_dv = 1.0 / torch.where(right == left, 1.0, right - left)
    return left, right, POWn[:-1], (POWn[1:] - POWn[:-1]) * inv_dv


def power_curve(wind_speed, V, POW, P):
    """Normalised turbine power curve interp(V, POW/P).  Outside
    [V[0], V[-1]] it clamps to the end values, as numpy.interp does;
    membership is [left, right), so a query exactly on a duplicated
    (cut-out) knot takes the post-jump segment; NaN stays NaN.

    Each value's segment is found by ``searchsorted`` and gathered, so the
    memory is that of the field whatever the knot count (a mask per
    segment would hold one field a knot: 44 GiB for a smoothed 72-knot
    curve on 1440 h of 115,921 cells); the value is the same
    ``start + (x - left) * slope`` of that one segment."""
    POWn = POW / P
    left, _, start, slope = curve_segments(V, POWn)
    # the last knot <= x; a duplicated knot's second copy, so the post-jump
    # segment; -1 below the curve, K-1 at or above its end
    seg = torch.searchsorted(V, wind_speed.contiguous(), right=True) - 1
    inside = (seg >= 0) & (seg < len(left))
    i = seg.clamp(0, len(left) - 1)
    out = torch.where(inside, start[i] + (wind_speed - left[i]) * slope[i], 0.0)
    out = (out + torch.where(wind_speed < V[0], POWn[0], 0.0)
           + torch.where(wind_speed >= V[-1], POWn[-1], 0.0))
    return torch.where(torch.isnan(wind_speed), torch.nan, out)
