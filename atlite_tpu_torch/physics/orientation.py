"""Panel surface orientation (counterpart of
``atlite_tpu/physics/orientation.py``).

Conventions: ``slope`` is the panel-ground angle; ``azimuth`` is clockwise
from North (pi faces South); all angles in radians.  Fixed panels and the
four tracking modes (``horizontal``, ``tilted_horizontal``, ``vertical``,
``dual``).
"""

from __future__ import annotations

import math

import torch

from atlite_tpu_torch.physics.solar import solar_position_trig

TRACKING_MODES = (None, "horizontal", "tilted_horizontal", "vertical", "dual")


def get_orientation(name, **params):
    """Return an orientation spec dict from a name or explicit parameters:
    'latitude_optimal', 'constant' (slope/azimuth in DEGREES) or 'latitude'
    (slope follows latitude)."""
    if isinstance(name, dict):
        params = dict(name)
        name = params.pop("name", "constant")
    if name == "latitude_optimal":
        return {"kind": "latitude_optimal"}
    if name == "constant":
        return {
            "kind": "constant",
            "slope": float(params.get("slope", 0.0)),
            "azimuth": float(params.get("azimuth", 0.0)),
        }
    if name == "latitude":
        return {"kind": "latitude", "azimuth": float(params.get("azimuth", 180))}
    raise ValueError(f"unknown orientation {name!r}")


def orientation_fields(spec, lat):
    """Evaluate an orientation spec to (slope, azimuth) fields.

    ``lat`` is a (Y,) tensor in degrees; outputs broadcast as (1, Y, 1)
    tensors or are Python floats.  latitude_optimal is the piecewise fit
    0.87*|lat| up to 25 deg, 0.76*|lat| + 0.31 deg up to 50 deg, else
    40 deg, facing the equator.  The breakpoints are compared in the
    dtype of ``lat``: at exactly 50 deg float32 takes the middle branch.
    """
    latr = torch.deg2rad(lat)[None, :, None]
    kind = spec["kind"]
    if kind == "constant":
        return math.radians(spec["slope"]), math.radians(spec["azimuth"])
    if kind == "latitude":
        return latr, math.radians(spec["azimuth"])
    if kind == "latitude_optimal":
        a = torch.abs(latr)
        slope = torch.where(
            a <= math.radians(25.0),
            0.87 * a,
            torch.where(a <= math.radians(50.0), 0.76 * a + math.radians(0.31),
                        math.radians(40.0)),
        )
        azimuth = torch.where(latr < 0, 0.0, torch.full_like(latr, math.pi))
        return slope, azimuth
    raise ValueError(f"unknown orientation kind {kind!r}")


def surface_orientation(solar_position, lat, orientation_spec, tracking=None):
    """cos(incidence), effective slope and panel azimuth for a fixed panel
    or a tracking mode; negative cos(incidence) (sun behind the panel) is
    clipped to 0.

    The tilted single-axis tracker moves its rotation angle into the
    sun's half-plane (the quadrant fix-ups); ``vertical`` and ``dual``
    return the static slope and azimuth of the orientation, as the
    reference does.
    """
    if tracking not in TRACKING_MODES:
        raise AssertionError(
            "tracking must be None, 'horizontal', 'tilted_horizontal', "
            "'vertical' or 'dual'"
        )
    slope, panel_az = orientation_fields(orientation_spec, lat)
    slope = torch.as_tensor(slope, dtype=lat.dtype, device=lat.device)
    panel_az = torch.as_tensor(panel_az, dtype=lat.dtype, device=lat.device)
    sp = solar_position_trig(solar_position)
    az = sp["azimuth"]
    sin_alt, cos_alt = sp["sin_altitude"], sp["cos_altitude"]
    surface_slope, surface_azimuth = slope, panel_az

    if tracking is None:
        # cos(panel_az - az) = cos(panel_az) cos(az) + sin(panel_az) sin(az)
        cos_rel = (torch.cos(panel_az) * sp["cos_azimuth"]
                   + torch.sin(panel_az) * sp["sin_azimuth"])
        cosincidence = torch.sin(slope) * cos_alt * cos_rel + torch.cos(slope) * sin_alt
    elif tracking == "horizontal":
        # one horizontal axis along the panel azimuth
        rotation = torch.arctan((cos_alt / sin_alt) * torch.sin(az - panel_az))
        surface_slope = torch.abs(rotation)
        surface_azimuth = panel_az + torch.arcsin(torch.sin(rotation) / torch.sin(surface_slope))
        cosincidence = (torch.cos(surface_slope) * sin_alt
                        + torch.sin(surface_slope) * cos_alt * torch.cos(az - surface_azimuth))
    elif tracking == "tilted_horizontal":
        rotation = torch.arctan(
            (cos_alt * torch.sin(az - panel_az))
            / (cos_alt * torch.cos(az - panel_az) * torch.sin(slope)
               + sin_alt * torch.cos(slope)))
        surface_slope = torch.arccos(torch.cos(rotation) * torch.cos(slope))
        dazi = az - panel_az
        dazi = torch.where(dazi > math.pi, dazi - 2 * math.pi, dazi)
        dazi = torch.where(dazi < -math.pi, dazi + 2 * math.pi, dazi)
        rotation = torch.where((rotation < 0) & (dazi > 0), rotation + math.pi, rotation)
        rotation = torch.where((rotation > 0) & (dazi < 0), rotation - math.pi, rotation)
        cosincidence = torch.cos(rotation) * (
            torch.sin(slope) * cos_alt * torch.cos(az - panel_az)
            + torch.cos(slope) * sin_alt
        ) + torch.sin(rotation) * cos_alt * torch.sin(az - panel_az)
    elif tracking == "vertical":
        cosincidence = torch.sin(slope) * cos_alt + torch.cos(slope) * sin_alt
    else:  # dual: the panel faces the sun
        cosincidence = torch.ones_like(sin_alt)

    return {
        "cosincidence": torch.clamp(cosincidence, min=0.0),
        "slope": surface_slope,
        "azimuth": surface_azimuth,
        "tracking": tracking,
    }
