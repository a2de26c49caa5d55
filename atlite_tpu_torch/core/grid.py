"""Static cutout grid descriptor (counterpart of
``atlite_tpu/core/grid.py``), with the calendar in numpy ``datetime64``.

``coordinate_range`` builds the lattice of a new cutout: a global
``arange(-180, 180, dx)`` / ``arange(-90, 90, dy)`` rounded to 9 decimals,
subset by inclusive label slices, and hourly (or ``dt``) stamps from 1940
to now, subset by partial ISO labels that include their whole period
("2013-12-31" runs to 23:00).

``Grid.dt`` is the stamps' frequency string as pandas' ``infer_freq``
gives it, inferred here without pandas (``infer_freq``, ``step_string``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np

from atlite_tpu_torch.core.timeutil import calendar_fields, parse_timedelta

_PARTIAL = re.compile(r"(\d{4})(?:-(\d{1,2}))?(?:-(\d{1,2}))?")


class Affine(NamedTuple):
    """Row-major 2x3 affine transform, rasterio ``Affine`` convention:
    ``x = a*col + b*row + c``; ``y = d*col + e*row + f``."""

    a: float
    b: float
    c: float
    d: float
    e: float
    f: float

    def __mul__(self, colrow):
        col, row = colrow
        return (self.a * col + self.b * row + self.c,
                self.d * col + self.e * row + self.f)

    @property
    def inverse(self):
        det = self.a * self.e - self.b * self.d
        a, b, c, d, e, f = self
        return Affine(e / det, -b / det, (b * f - e * c) / det,
                      -d / det, a / det, (d * c - a * f) / det)


def _timestamp(label):
    """A ``datetime64[ns]`` of an ISO label; "2011-1-5" reads as 2011-01-05."""
    label = str(label).strip()
    m = _PARTIAL.fullmatch(label)
    if m is not None:
        y, mo, d = m.groups()
        label = f"{y}-{int(mo or 1):02d}-{int(d or 1):02d}"
    return np.datetime64(label.replace(" ", "T"), "ns")


def _end_of(label):
    """Inclusive end of a partial ISO label ("2011" -> 2011-12-31
    23:59:59.999999999, like pandas label slicing); any other label is an
    instant."""
    label = str(label).strip()
    m = _PARTIAL.fullmatch(label)
    if m is None:
        return _timestamp(label)
    y, mo, d = m.groups()
    if d is not None:
        start, unit = f"{y}-{int(mo):02d}-{int(d):02d}", "D"
    elif mo is not None:
        start, unit = f"{y}-{int(mo):02d}", "M"
    else:
        start, unit = y, "Y"
    nxt = np.datetime64(start, unit) + np.timedelta64(1, unit)
    return nxt.astype("datetime64[ns]") - np.timedelta64(1, "ns")


def _step(dt):
    """The stamp spacing of a frequency such as "h", "3h" or "D"."""
    s = str(dt).strip()
    return parse_timedelta(s if s[:1].isdigit() else "1" + s)


def coordinate_range(x, y, time, dx=0.25, dy=0.25, dt="h"):
    """Build the (x, y, time) lattice for a new cutout."""
    if isinstance(x, (tuple, list)):
        x = slice(*x)
    if isinstance(y, (tuple, list)):
        y = slice(*y)
    x0, x1 = sorted((float(x.start), float(x.stop)))
    y0, y1 = sorted((float(y.start), float(y.stop)))

    xs = np.round(np.arange(-180, 180, dx), 9)
    ys = np.round(np.arange(-90, 90, dy), 9)
    xs = xs[(xs >= x0) & (xs <= x1)]
    ys = ys[(ys >= y0) & (ys <= y1)]

    step = _step(dt)
    start = np.datetime64("1940-01-01", "ns")
    now = np.datetime64("now", "ns")
    times = start + np.arange((now - start) // step + 1) * step
    if isinstance(time, slice):
        lo, hi = time.start, time.stop
    elif isinstance(time, (list, tuple)) and len(time) == 2:
        lo, hi = time
    else:
        lo = hi = str(time)  # a partial label selects its whole period
    keep = np.ones(len(times), dtype=bool)
    if lo is not None:
        keep &= times >= _timestamp(lo)
    if hi is not None:
        keep &= times <= _end_of(hi)
    return xs.astype(float), ys.astype(float), times[keep]


@dataclass(frozen=True, eq=False)
class Grid:
    """Immutable cutout coordinate system (cell centres)."""

    x: np.ndarray  # (X,) float64, ascending cell-centre longitudes
    y: np.ndarray  # (Y,) float64, ascending cell-centre latitudes
    time: np.ndarray  # (T,) datetime64[ns]
    crs: int = 4326

    @property
    def shape(self):
        """(Y, X)."""
        return len(self.y), len(self.x)

    @property
    def ncells(self):
        return len(self.y) * len(self.x)

    @property
    def dx(self):
        x = self.x
        return round(float(x[-1] - x[0]) / (len(x) - 1), 8) if len(x) > 1 else 0.0

    @property
    def dy(self):
        y = self.y
        return round(float(y[-1] - y[0]) / (len(y) - 1), 8) if len(y) > 1 else 0.0

    @property
    def time_index(self):
        """The stamps as ``datetime64[ns]`` (a ``DatetimeIndex`` in the
        JAX package)."""
        return np.asarray(self.time, dtype="datetime64[ns]")

    @property
    def dt(self):
        """The stamps' frequency string (pandas' ``infer_freq``); two stamps
        give their step as an offset string, one stamp gives None."""
        t = self.time_index
        if len(t) < 3:
            return step_string(t[1] - t[0]) if len(t) == 2 else None
        return infer_freq(t)

    @property
    def extent(self):
        """(xmin, xmax, ymin, ymax) of the covered area."""
        dx, dy = self.dx, self.dy
        return np.array([self.x[0] - dx / 2, self.x[-1] + dx / 2,
                         self.y[0] - dy / 2, self.y[-1] + dy / 2])

    @property
    def bounds(self):
        """(xmin, ymin, xmax, ymax)."""
        return self.extent[[0, 2, 1, 3]]

    @property
    def transform(self):
        """Affine with positive (northward) dy."""
        return Affine(self.dx, 0, float(self.x[0]) - self.dx / 2,
                      0, self.dy, float(self.y[0]) - self.dy / 2)

    @property
    def transform_r(self):
        """Affine with negative dy (top-down row order)."""
        return Affine(self.dx, 0, float(self.x[0]) - self.dx / 2,
                      0, -self.dy, float(self.y[-1]) + self.dy / 2)

    def meshgrid(self):
        """(lon2d, lat2d) of cell centres, each (Y, X)."""
        return np.meshgrid(self.x, self.y)

    def cell_bounds(self):
        """(ncells, 4) [xmin, ymin, xmax, ymax] per cell, x fastest."""
        xs, ys = self.meshgrid()
        cx, cy = xs.ravel(), ys.ravel()
        dx2, dy2 = self.dx / 2, self.dy / 2
        return np.column_stack([cx - dx2, cy - dy2, cx + dx2, cy + dy2])

    def cell_coords(self):
        """(ncells, 2) cell-centre (x, y), x fastest."""
        xs, ys = self.meshgrid()
        return np.column_stack([xs.ravel(), ys.ravel()])

    def sel(self, x=None, y=None, time=None):
        """Subset by inclusive label slices; a time label that is not a
        slice selects its whole period."""
        def mask(vals, sl):
            lo, hi = sl.start, sl.stop
            if lo is not None and hi is not None:
                lo, hi = sorted((lo, hi))
            m = np.ones(len(vals), dtype=bool)
            if lo is not None:
                m &= vals >= lo
            if hi is not None:
                m &= vals <= hi
            return m

        g = self
        if x is not None:
            g = replace(g, x=g.x[mask(g.x, x)])
        if y is not None:
            g = replace(g, y=g.y[mask(g.y, y)])
        if time is not None:
            t = g.time_index
            if isinstance(time, slice):
                lo, hi = time.start, time.stop
            else:
                lo = hi = str(time)
            m = np.ones(len(t), dtype=bool)
            if lo is not None:
                m &= t >= _timestamp(lo)
            if hi is not None:
                m &= t <= _end_of(hi)
            g = replace(g, time=g.time[m])
        return g


# ---------------------------------------------------------------------------
# frequency strings (pandas 3's ``to_offset(Timedelta).freqstr`` and
# ``infer_freq``, on datetime64[ns])
# ---------------------------------------------------------------------------
_NS_DAY = 86_400 * 10**9
_UNITS = (("h", 3600 * 10**9), ("min", 60 * 10**9), ("s", 10**9), ("ms", 10**6),
          ("us", 10**3), ("ns", 1))
_MONTHS = ("JAN", "FEB", "MAR", "APR", "MAY", "JUN", "JUL", "AUG", "SEP", "OCT", "NOV",
           "DEC")
_WEEKDAYS = ("MON", "TUE", "WED", "THU", "FRI", "SAT", "SUN")


def _count(base, n):
    return base if n == 1 else f"{int(n)}{base}"


def step_string(delta):
    """The offset string of a step (``to_offset(Timedelta).freqstr``):
    whole hours as "h"/"3h"/"24h", else minutes, seconds, ms, us, ns."""
    ns = int(np.timedelta64(delta, "ns").astype(np.int64))
    for base, unit in _UNITS:
        if ns % unit == 0:
            return _count(base, ns // unit)
    raise AssertionError("unreachable")


def _unique_deltas(a):
    return np.unique(np.diff(np.asarray(a, dtype=np.int64)))


def _month_position(f, weekday):
    """pandas' ``month_position_check``: "ce"/"be"/"cs"/"bs" when every
    stamp is a calendar/business month end/start, else None."""
    y, m, d = f["year"], f["month"], f["day"]
    month0 = (y - 1970) * 12 + m - 1
    nxt = (month0 + 1).astype("datetime64[M]").astype("datetime64[D]")
    dim = (nxt - month0.astype("datetime64[M]").astype("datetime64[D]")).astype(np.int64)
    checks = {
        "ce": d == dim,
        "be": (d == dim) | ((dim - d <= 2) & (weekday == 4)),
        "cs": d == 1,
        "bs": (d == 1) | ((d <= 3) & (weekday == 0)),
    }
    for k in ("ce", "be", "cs", "bs"):
        if checks[k].all():
            return k
    return None


def _unique_in_order(a):
    _, first = np.unique(a, return_index=True)
    return a[np.sort(first)]


def infer_freq(time):
    """pandas' ``infer_freq`` of three or more ``datetime64[ns]`` stamps:
    "h", "3h", "D", "W-TUE", "MS", "YS-JAN", ... or None when irregular."""
    t = np.asarray(time, dtype="datetime64[ns]")
    i8 = t.astype(np.int64)
    if len(i8) < 3:
        raise ValueError("Need at least 3 dates to infer frequency")
    d = np.diff(i8)
    if not ((d >= 0).all() or (d <= 0).all()) or len(np.unique(i8)) != len(i8):
        return None
    deltas = _unique_deltas(i8)
    delta = int(deltas[0])
    if delta and delta % _NS_DAY == 0:
        return _daily_rule(t, i8, deltas)
    hours = [x / 3600e9 for x in deltas]
    if hours in ([1, 17], [1, 65], [1, 17, 65]):
        return "bh"
    if len(deltas) != 1:
        return None
    for base, unit in _UNITS:
        if delta % unit == 0:
            return _count(base, delta / unit)
    raise AssertionError("unreachable")


def _daily_rule(t, i8, deltas):
    f = calendar_fields(t)
    weekday = (t.astype("datetime64[D]").astype(np.int64) + 3) % 7  # 1970-01-01: Thursday
    ydiffs = _unique_deltas(f["year"])
    mdiffs = _unique_deltas(f["year"] * 12 + f["month"])
    rep_month, rep_weekday = int(f["month"][0]), int(weekday[0])
    if len(ydiffs) == 1 and len(np.unique(f["month"])) == 1:
        pos = _month_position(f, weekday)
        if pos is not None:
            alias = {"cs": "YS", "bs": "BYS", "ce": "YE", "be": "BYE"}[pos]
            return _count(f"{alias}-{_MONTHS[rep_month - 1]}", ydiffs[0])
    if len(mdiffs) == 1 and mdiffs[0] % 3 == 0:
        pos = _month_position(f, weekday)
        if pos is not None:
            alias = {"cs": "QS", "bs": "BQS", "ce": "QE", "be": "BQE"}[pos]
            month = {0: 12, 2: 11, 1: 10}[rep_month % 3]
            return _count(f"{alias}-{_MONTHS[month - 1]}", mdiffs[0] / 3)
    if len(mdiffs) == 1:
        pos = _month_position(f, weekday)
        if pos is not None:
            return _count({"cs": "MS", "bs": "BMS", "ce": "ME", "be": "BME"}[pos], mdiffs[0])
    if len(deltas) == 1:
        days = deltas[0] / _NS_DAY
        if days % 7 == 0:
            return _count(f"W-{_WEEKDAYS[rep_weekday]}", days / 7)
        return _count("D", days)
    if [x / _NS_DAY for x in deltas] == [1, 3]:
        shifts = np.diff(i8) // _NS_DAY
        wd = np.mod(rep_weekday + np.cumsum(shifts), 7)
        if np.all(((wd == 0) & (shifts == 3)) | ((wd > 0) & (wd <= 4) & (shifts == 1))):
            return "B"
    weekdays = np.unique(weekday)
    if len(weekdays) > 1:
        return None
    wom = _unique_in_order((f["day"] - 1) // 7)
    wom = wom[wom < 4]
    if len(wom) != 1:
        return None
    return f"WOM-{int(wom[0]) + 1}{_WEEKDAYS[int(weekdays[0])]}"
