"""Tilted-plane irradiation (counterpart of
``atlite_tpu/physics/irradiation.py``).

Reindl decomposition of global horizontal irradiance, transposition by the
'simple' trigonometric model or Hay-Davies, ground reflection via albedo
and the low-sun suppression mask.  Night-time NaN paths are zeroed by the
same masks the reference applies.
"""

from __future__ import annotations

import math

import torch


def diffuse_horizontal_fraction(k, sinaltitude, temperature=None, humidity=None,
                                clearsky_model="simple"):
    """Reindl diffuse fraction of the clearsky index k = influx/influx_toa;
    NaN k (night, influx_toa == 0) gives 0."""
    if clearsky_model == "simple":
        b1 = torch.clamp(1.020 - 0.254 * k + 0.0123 * sinaltitude, max=1.0)
        b2 = torch.clamp(torch.clamp(1.400 - 1.749 * k + 0.177 * sinaltitude,
                                     min=0.1), max=0.97)
        b3 = torch.clamp(0.486 * k - 0.182 * sinaltitude, min=0.1)
    elif clearsky_model == "enhanced":
        T, rh = temperature, humidity
        b1 = torch.clamp(1.000 - 0.232 * k + 0.0239 * sinaltitude
                         - 0.000682 * T + 0.0195 * rh, max=1.0)
        b2 = torch.clamp(torch.clamp(
            1.329 - 1.716 * k + 0.267 * sinaltitude - 0.00357 * T + 0.106 * rh,
            min=0.1), max=0.97)
        b3 = torch.clamp(0.426 * k - 0.256 * sinaltitude
                         + 0.00349 * T + 0.0734 * rh, min=0.1)
    else:
        raise KeyError("`clearsky model` must be chosen from 'simple' and 'enhanced'")
    # a mask times a value is a select in JAX (False * NaN == 0), so each
    # term is a where
    return (
        torch.where((k > 0.0) & (k <= 0.3), b1, 0.0)
        + torch.where((k > 0.3) & (k < 0.78), b2, 0.0)
        + torch.where(k >= 0.78, b3, 0.0)
    )


def _albedo(fields, influx):
    """Ground albedo: direct variable, or outflux/influx."""
    if "albedo" in fields:
        return fields["albedo"]
    if "outflux" in fields:
        a = fields["outflux"] / torch.where(influx != 0, influx, torch.nan)
        return torch.clamp(torch.nan_to_num(a, nan=0.0), max=1.0)
    raise AssertionError(
        "Need either albedo or outflux as a variable in the dataset. "
        "Check your cutout and dataset module."
    )


def _clip(x, lo, hi):
    """jnp.clip with a scalar floor and a tensor ceiling (NaN propagates)."""
    return torch.minimum(torch.clamp(x, min=lo), hi)


def tilted_irradiation(
    fields,
    solar_position,
    surface,
    trigon_model="simple",
    clearsky_model="simple",
    tracking=None,
    altitude_threshold=1.0,
    irradiation="total",
):
    """Irradiation on the tilted plane.

    fields: dict of (T, Y, X) tensors with either 'influx' (global
    horizontal) or 'influx_direct' + 'influx_diffuse', plus 'influx_toa'
    and albedo info.  ``trigon_model`` is 'simple'; any other name is the
    Hay-Davies model.
    """
    influx_toa = fields["influx_toa"]
    if "sin_altitude" in solar_position:
        sinaltitude = solar_position["sin_altitude"]
    else:
        sinaltitude = torch.sin(solar_position["altitude"])
    cosincidence = surface["cosincidence"]
    surface_slope = surface["slope"]

    if "influx" in fields:
        influx = _clip(fields["influx"], 0.0, influx_toa)
        if clearsky_model is None:
            clearsky_model = (
                "enhanced"
                if "temperature" in fields and "humidity" in fields
                else "simple"
            )
        k = influx / influx_toa
        fraction = diffuse_horizontal_fraction(
            k, sinaltitude,
            temperature=fields.get("temperature"),
            humidity=fields.get("humidity"),
            clearsky_model=clearsky_model,
        )
        diffuse = influx * fraction
        direct = influx - diffuse
    elif "influx_direct" in fields and "influx_diffuse" in fields:
        direct = _clip(fields["influx_direct"], 0.0, influx_toa)
        diffuse = _clip(fields["influx_diffuse"], 0.0, influx_toa - direct)
    else:
        raise AssertionError(
            "Need either influx or influx_direct and influx_diffuse in the "
            "dataset. Check your cutout and dataset module."
        )

    surface_slope = torch.as_tensor(surface_slope)
    influx = direct + diffuse
    if trigon_model == "simple":
        k_geom = cosincidence / sinaltitude
        # only the simple model reads the sun's altitude as the dual
        # tracker's slope
        cos_surface_slope = torch.cos(surface_slope) if tracking != "dual" else sinaltitude
        direct_t = k_geom * direct
        diffuse_t = (1.0 + cos_surface_slope) / 2.0 * diffuse
        ground_t = _albedo(fields, influx) * influx * ((1.0 - cos_surface_slope) / 2.0)
        total_t = (torch.nan_to_num(direct_t, nan=0.0)
                   + torch.nan_to_num(diffuse_t, nan=0.0)
                   + torch.nan_to_num(ground_t, nan=0.0))
    else:
        # Hay-Davies anisotropic diffuse: horizon brightening f,
        # anisotropy index A, beam ratio R_b
        f = torch.nan_to_num(torch.sqrt(direct / influx), nan=0.0)
        A = direct / influx_toa
        R_b = cosincidence / sinaltitude
        diffuse_t = (
            (1.0 - A) * ((1 + torch.cos(surface_slope)) / 2.0)
            * (1.0 + f * torch.sin(surface_slope / 2.0) ** 3)
            + A * R_b
        ) * diffuse
        diffuse_t = torch.nan_to_num(torch.clamp(diffuse_t, min=0.0), nan=0.0)
        direct_t = R_b * direct
        ground_t = influx * _albedo(fields, influx) * (1.0 - torch.cos(surface_slope)) / 2.0
        total_t = direct_t + diffuse_t + ground_t

    result = {
        "total": total_t, "direct": direct_t, "diffuse": diffuse_t, "ground": ground_t,
    }[irradiation]

    # suppress irradiation at low solar altitude where 1/sin(alt) blows up;
    # this also zeroes every night-time NaN path.  Compared in sin-space,
    # which is monotone on [-pi/2, pi/2]
    cap_alt = sinaltitude < math.sin(math.radians(altitude_threshold))
    return torch.where(cap_alt | (direct + diffuse <= 0.01), 0.0, result)
