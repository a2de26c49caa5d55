"""Deterministic synthetic ERA5-like weather (counterpart of
``atlite_tpu/datasets/synthetic.py``).

The same seeded analytic fields as the JAX package's generator.  The
dataset module contract (``crs``, ``features``, ``static_features``,
``get_data(cutout, feature, tmpdir=None, **params)``) serves the Cutout;
``generate`` takes the grid as ``x, y, times, seed`` for the headline
step's inputs.  Calendar math runs on numpy ``datetime64``
(``core/timeutil.py``), so it needs no pandas.
"""

from __future__ import annotations

import hashlib

import numpy as np

from atlite_tpu_torch.core.timeutil import (
    calendar_fields,
    solar_ephemeris,
    to_datetime64,
)
from atlite_tpu_torch.physics.solar import solar_position_numpy

crs = 4326

features = {
    "height": ["height"],
    "wind": ["wnd100m", "wnd10m", "wnd_shear_exp", "wnd_azimuth", "roughness"],
    "influx": [
        "influx_toa",
        "influx_direct",
        "influx_diffuse",
        "albedo",
        "solar_altitude",
        "solar_azimuth",
    ],
    "temperature": ["temperature", "soil temperature", "dewpoint temperature"],
    "runoff": ["runoff"],
}

static_features = {"height"}

SOLAR_CONSTANT = 1361.0  # W/m^2
_EPOCH = np.datetime64("2000-01-01", "ns")


def _rng(seed, name):
    h = hashlib.sha256(f"{seed}:{name}".encode()).digest()
    return np.random.default_rng(np.frombuffer(h[:8], dtype=np.uint64)[0])


def _smooth_field(seed, name, times, lon, lat, nharm=4):
    """Smooth space-time field in [0, 1], deterministic in (seed, name)."""
    rng = _rng(seed, name)
    ns = (to_datetime64(times) - _EPOCH).astype(np.int64)
    t_hours = ((ns / 10**9) / 3600.0)[:, None, None]
    lon2 = np.deg2rad(lon)[None, None, :]
    lat2 = np.deg2rad(lat)[None, :, None]
    acc = np.zeros((len(t_hours), len(lat), len(lon)))
    for _ in range(nharm):
        fx, fy = rng.uniform(0.5, 4.0, 2)
        ft = rng.choice([1 / 24.0, 1 / (24.0 * 365), 1 / 37.0, 1 / 11.0])
        px, py, pt = rng.uniform(0, 2 * np.pi, 3)
        acc += rng.uniform(0.3, 1.0) * np.sin(
            2 * np.pi * ft * t_hours + fx * lon2 + px
        ) * np.cos(fy * lat2 + py + 0.3 * np.sin(2 * np.pi * ft * t_hours + pt))
    acc /= np.abs(acc).max() + 1e-12
    return 0.5 + 0.5 * acc


def _static_field(seed, name, lon, lat, nharm=5):
    rng = _rng(seed, name)
    lon2 = np.deg2rad(lon)[None, :]
    lat2 = np.deg2rad(lat)[:, None]
    acc = np.zeros((len(lat), len(lon)))
    for _ in range(nharm):
        fx, fy = rng.uniform(0.5, 6.0, 2)
        px, py = rng.uniform(0, 2 * np.pi, 2)
        acc += rng.uniform(0.3, 1.0) * np.sin(fx * lon2 + px) * np.cos(fy * lat2 + py)
    acc /= np.abs(acc).max() + 1e-12
    return 0.5 + 0.5 * acc


def get_data(cutout, feature, tmpdir=None, **creation_parameters):
    """Generate one feature on the cutout's grid, seeded by its ``seed``
    attribute (default 42); returns {var: (dims, np.ndarray)}."""
    grid = cutout.grid_desc
    return generate(feature, grid.x, grid.y, grid.time, int(cutout.attrs.get("seed", 42)))


def generate(feature, x, y, times, seed=42):
    """Generate one feature on the grid (x: (X,) lon, y: (Y,) lat, times:
    (T,) stamps); returns {var: (dims, float64 array)}."""
    lon, lat = np.asarray(x), np.asarray(y)
    tyx = ("time", "y", "x")

    if feature == "height":
        h = (_static_field(seed, "height", lon, lat) * 2200.0) - 200.0
        return {"height": (("y", "x"), h)}

    if feature == "wind":
        w100 = 2.0 + 18.0 * _smooth_field(seed, "wnd100m", times, lon, lat) ** 1.5
        shear_sigma = 0.1 + 0.25 * _smooth_field(seed, "shear", times, lon, lat)
        w10 = w100 * (10.0 / 100.0) ** shear_sigma
        shear = np.log(w10 / w100) / np.log(10 / 100)
        azim = 2 * np.pi * _smooth_field(seed, "wnd_azimuth", times, lon, lat)
        rough = 2e-4 + 1.2 * _static_field(seed, "roughness", lon, lat) ** 3
        rough_t = np.broadcast_to(rough, w100.shape).copy()
        return {
            "wnd100m": (tyx, w100),
            "wnd10m": (tyx, w10),
            "wnd_shear_exp": (tyx, shear),
            "wnd_azimuth": (tyx, azim),
            "roughness": (tyx, rough_t),
        }

    if feature == "influx":
        # ERA5 fluxes are means over the preceding hour; solar position is
        # evaluated at the interval center
        eph = solar_ephemeris(times, time_shift="-30min")
        sp = solar_position_numpy(eph["declination"], eph["hour_angle0"], lon, lat)
        alt = sp["altitude"]
        az = sp["azimuth"]

        toa = SOLAR_CONSTANT * np.clip(np.sin(alt), 0.0, None)
        clearness = 0.3 + 0.55 * _smooth_field(seed, "clearness", times, lon, lat)
        total = clearness * toa
        direct_frac = np.clip(1.4 * (clearness - 0.25), 0.0, 0.9)
        influx_direct = direct_frac * total
        influx_diffuse = total - influx_direct
        albedo = 0.05 + 0.3 * _static_field(seed, "albedo", lon, lat)
        albedo_t = np.broadcast_to(albedo, toa.shape).copy()
        return {
            "influx_toa": (tyx, toa),
            "influx_direct": (tyx, influx_direct),
            "influx_diffuse": (tyx, influx_diffuse),
            "albedo": (tyx, albedo_t),
            "solar_altitude": (tyx, alt),
            "solar_azimuth": (tyx, az),
        }

    if feature == "temperature":
        cal = calendar_fields(times)
        seasonal = np.cos(2 * np.pi * (cal["dayofyear"] - 200) / 365.0)
        diurnal = np.cos(2 * np.pi * (cal["hour"] - 14) / 24.0)
        latfac = np.cos(np.deg2rad(lat))[None, :, None]
        base = 255.0 + 35.0 * latfac
        T = (
            base
            + 8.0 * seasonal[:, None, None]
            + 4.0 * diurnal[:, None, None]
            + 6.0 * (_smooth_field(seed, "temperature", times, lon, lat) - 0.5)
        )
        sea = _static_field(seed, "landmask", lon, lat) < 0.25
        soil = T + 2.0 * (_smooth_field(seed, "soil", times, lon, lat) - 0.5)
        soil = np.where(sea[None, :, :], np.nan, soil)
        dew = T - (2.0 + 8.0 * _smooth_field(seed, "dewpoint", times, lon, lat))
        return {
            "temperature": (tyx, T),
            "soil temperature": (tyx, soil),
            "dewpoint temperature": (tyx, dew),
        }

    if feature == "runoff":
        r = _smooth_field(seed, "runoff", times, lon, lat)
        runoff = np.clip(r - 0.35, 0.0, None) ** 2 * 2e-3
        return {"runoff": (tyx, runoff)}

    raise ValueError(f"unknown feature {feature!r}")
