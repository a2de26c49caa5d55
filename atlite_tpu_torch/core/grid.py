"""Static cutout grid descriptor (counterpart of
``atlite_tpu/core/grid.py``), with the calendar in numpy ``datetime64``.

``coordinate_range`` builds the lattice of a new cutout: a global
``arange(-180, 180, dx)`` / ``arange(-90, 90, dy)`` rounded to 9 decimals,
subset by inclusive label slices, and hourly (or ``dt``) stamps from 1940
to now, subset by partial ISO labels that include their whole period
("2013-12-31" runs to 23:00).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from atlite_tpu_torch.core.timeutil import parse_timedelta

_PARTIAL = re.compile(r"(\d{4})(?:-(\d{1,2}))?(?:-(\d{1,2}))?")


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
