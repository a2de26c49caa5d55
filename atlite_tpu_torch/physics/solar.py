"""Solar position (counterpart of ``atlite_tpu/physics/solar.py``).

Per-time float64 ephemeris tables come from the host
(``core/timeutil.solar_ephemeris``); this module broadcasts them over
(time, y, x) as tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def solar_position(declination, hour_angle0, lon, lat):
    """Solar altitude/azimuth fields.

    declination, hour_angle0: (T,) tensors [rad]; lon: (X,), lat: (Y,)
    tensors [deg].  Returns a dict with ``altitude`` and ``azimuth``
    (T, Y, X) [rad] (azimuth clockwise from North) and their (sin, cos)
    pairs.
    """
    dec = declination[:, None, None]
    two_pi = 2 * math.pi
    h = torch.remainder(
        hour_angle0[:, None, None] + torch.deg2rad(lon)[None, None, :] + math.pi,
        two_pi) - math.pi
    latr = torch.deg2rad(lat)[None, :, None]

    sin_dec, cos_dec = torch.sin(dec), torch.cos(dec)
    sin_lat, cos_lat = torch.sin(latr), torch.cos(latr)
    cos_h = torch.cos(h)

    # clip against rounding excursions beyond +-1
    sin_alt = torch.clamp(sin_dec * sin_lat + cos_dec * cos_lat * cos_h, -1.0, 1.0)
    alt = torch.arcsin(sin_alt)
    # altitude is in [-pi/2, pi/2], so cos >= 0
    cos_alt = torch.sqrt(torch.clamp(1.0 - sin_alt**2, min=0.0))
    cos_az = torch.clamp(
        (sin_dec * cos_lat - cos_dec * sin_lat * cos_h) / cos_alt, -1.0, 1.0)
    az = torch.arccos(cos_az)
    az = torch.where(h <= 0, az, two_pi - az)
    # sin(az) keeps the hemisphere flip's sign: az' = 2pi - az
    sin_az = torch.sqrt(torch.clamp(1.0 - cos_az**2, min=0.0))
    sin_az = torch.where(h <= 0, sin_az, -sin_az)
    return {"altitude": alt, "azimuth": az,
            "sin_altitude": sin_alt, "cos_altitude": cos_alt,
            "sin_azimuth": sin_az, "cos_azimuth": cos_az}


def solar_position_trig(solar_position_dict):
    """Ensure a solar-position dict carries the (sin, cos) pairs — derives
    them from the angles when absent (stored-angle fast lane)."""
    sp = dict(solar_position_dict)
    if "sin_altitude" not in sp:
        sp["sin_altitude"] = torch.sin(sp["altitude"])
        sp["cos_altitude"] = torch.cos(sp["altitude"])
    if "sin_azimuth" not in sp:
        sp["sin_azimuth"] = torch.sin(sp["azimuth"])
        sp["cos_azimuth"] = torch.cos(sp["azimuth"])
    return sp


def solar_position_numpy(declination, hour_angle0, lon, lat):
    """Float64 numpy twin of :func:`solar_position` (angles only), used by
    the synthetic weather generator."""
    dec = np.asarray(declination)[:, None, None]
    two_pi = 2 * np.pi
    h = (np.asarray(hour_angle0)[:, None, None]
         + np.radians(lon)[None, None, :] + np.pi) % two_pi - np.pi
    latr = np.radians(lat)[None, :, None]
    alt = np.arcsin(
        np.clip(np.sin(dec) * np.sin(latr) + np.cos(dec) * np.cos(latr) * np.cos(h),
                -1.0, 1.0)
    )
    az = np.arccos(
        np.clip((np.sin(dec) * np.cos(latr) - np.cos(dec) * np.sin(latr) * np.cos(h))
                / np.cos(alt), -1.0, 1.0)
    )
    az = np.where(h <= 0, az, two_pi - az)
    return {"altitude": alt, "azimuth": az}
