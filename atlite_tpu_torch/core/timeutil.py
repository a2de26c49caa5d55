"""Host-side time math on numpy ``datetime64`` (counterpart of
``atlite_tpu/core/timeutil.py``).

Calendar fields come from ``datetime64[ns]`` alone, so the port runs
where pandas is not installed.  The Julian date repeats pandas'
``to_julian_date`` arithmetic term by term, so the ephemeris tables equal
the JAX package's bit for bit.
"""

from __future__ import annotations

import re

import numpy as np

_NS = {
    "ns": 1, "us": 10**3, "ms": 10**6, "s": 10**9, "sec": 10**9,
    "min": 60 * 10**9, "m": 60 * 10**9, "h": 3600 * 10**9,
    "hour": 3600 * 10**9, "d": 86400 * 10**9, "day": 86400 * 10**9,
}
_SHIFT = re.compile(r"\s*([+-]?)\s*(\d+(?:\.\d*)?)\s*([a-zA-Z]+)\s*")


def to_datetime64(time) -> np.ndarray:
    """(T,) ``datetime64[ns]`` array of the given stamps."""
    return np.asarray(time, dtype="datetime64[ns]").reshape(-1)


def parse_timedelta(shift) -> np.timedelta64:
    """A ``timedelta64[ns]`` from a string such as ``"-30min"`` or ``"0h"``
    (the forms ``pd.to_timedelta`` is given in the JAX package)."""
    if isinstance(shift, np.timedelta64):
        return shift.astype("timedelta64[ns]")
    m = _SHIFT.fullmatch(str(shift))
    unit = m.group(3).lower() if m else ""
    if unit not in _NS and unit.endswith("s"):
        unit = unit[:-1]  # plural: "hours", "mins"
    if unit not in _NS:
        raise ValueError(f"cannot parse time shift {shift!r}")
    ns = round(float(m.group(2)) * _NS[unit])
    return np.timedelta64(-ns if m.group(1) == "-" else ns, "ns")


def calendar_fields(t: np.ndarray) -> dict[str, np.ndarray]:
    """year, month, day, hour, minute, second, microsecond, nanosecond and
    dayofyear (int64 arrays) of ``datetime64[ns]`` stamps."""
    t = to_datetime64(t)
    years = t.astype("datetime64[Y]")
    months = t.astype("datetime64[M]")
    days = t.astype("datetime64[D]")
    ns = (t - days).astype(np.int64)
    return {
        "year": years.astype(np.int64) + 1970,
        "month": (months - years.astype("datetime64[M]")).astype(np.int64) + 1,
        "day": (days - months.astype("datetime64[D]")).astype(np.int64) + 1,
        "hour": ns // (3600 * 10**9),
        "minute": ns // (60 * 10**9) % 60,
        "second": ns // 10**9 % 60,
        "microsecond": ns // 10**3 % 10**6,
        "nanosecond": ns % 10**3,
        "dayofyear": (days - years.astype("datetime64[D]")).astype(np.int64) + 1,
    }


def to_julian_date(t: np.ndarray) -> np.ndarray:
    """Julian dates (float64), in the order of operations of pandas'
    ``DatetimeIndex.to_julian_date``."""
    f = calendar_fields(t)
    year, month, day = f["year"].copy(), f["month"].copy(), f["day"]
    early = month < 3
    year[early] -= 1
    month[early] += 12
    return (
        day
        + np.trunc((153 * month - 457) / 5)
        + 365 * year
        + np.floor(year / 4)
        - np.floor(year / 100)
        + np.floor(year / 400)
        + 1_721_118.5
        + (
            f["hour"]
            + f["minute"] / 60
            + f["second"] / 3600
            + f["microsecond"] / 3600 / 10**6
            + f["nanosecond"] / 3600 / 10**9
        )
        / 24
    )


def solar_ephemeris(time, time_shift="0h") -> dict[str, np.ndarray]:
    """Per-timestep solar ephemeris tables (float64, shape (T,)):
    ``declination`` and ``hour_angle0`` (hour angle at lon=0, wrapped to
    (-pi, pi]), by the Michalsky almanac approximation."""
    t = to_datetime64(time) + parse_timedelta(time_shift)
    n = to_julian_date(t) - 2451545.0
    since_midnight = (t - t.astype("datetime64[D]")).astype(np.int64)
    ut_hours = (since_midnight / 10**9) / 3600.0

    L = 280.460 + 0.9856474 * n  # mean longitude, deg
    g = np.radians(357.528 + 0.9856003 * n)  # mean anomaly, rad
    ecl = np.radians(L + 1.915 * np.sin(g) + 0.020 * np.sin(2 * g))  # ecliptic lon
    ep = np.radians(23.439 - 4e-7 * n)  # obliquity

    ra = np.arctan2(np.cos(ep) * np.sin(ecl), np.cos(ecl))  # right ascension
    lmst0 = (6.697375 + ut_hours + 0.0657098242 * n) * 15.0  # deg, lon=0
    # wrapped in float64 so the residual survives a float32 cast
    h0 = (np.radians(lmst0) - ra + np.pi) % (2 * np.pi) - np.pi
    dec = np.arcsin(np.sin(ep) * np.sin(ecl))

    return {"declination": dec, "hour_angle0": h0}


def daily_groups(time, hour_shift=0.0):
    """Group hourly stamps into days after a shift of ``hour_shift`` hours
    (xarray's ``assign_coords(time=time + shift).resample(time='1D')``).

    Returns ``(days, group_ids)``: the ``datetime64[ns]`` day starts in
    order of first appearance and a (T,) int32 map of each stamp to its
    day.
    """
    shift = np.timedelta64(round(float(hour_shift) * _NS["h"]), "ns")
    days = (to_datetime64(time) + shift).astype("datetime64[D]")
    _, first, inverse = np.unique(days, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    uniq = days[np.sort(first)].astype("datetime64[ns]")
    return uniq, rank[inverse.reshape(-1)].astype(np.int32)
