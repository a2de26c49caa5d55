"""Reference of ``Cutout.heat_demand``: atlite's degree-day heat demand,
``constant + max(a * (threshold + 273.15 - T_day), 0)``, where ``T_day``
is a day's mean temperature in K and ``threshold`` is in degC.

``T_day`` is the plain mean of each calendar day's 24 stamps, taken from
the benchmark's own hour stamps by a reshape: no ``index_add_``, no day
grouping of the program's.  Departures from atlite, which resamples any
stamps by xarray's ``resample(time="1D")`` after shifting them by
``hour_shift``: only ``hour_shift`` 0, and only blocks of whole days (24
consecutive stamps a day from midnight, as both cutouts of the benchmark
hold); anything else raises.
"""

from __future__ import annotations

import numpy as np
import torch

FIELDS = ("temperature",)
DAILY = True  # one step a day
KELVIN = 273.15
# relative L2 gap of a per-unit (days, B) series; set from the readings
# in PERF.md section 6
LIMIT = 1e-4


def fields(kwargs):
    """The fields a call with ``kwargs`` reads."""
    return FIELDS


def daily_mean(temperature, hours):
    """(days, C) mean of each day's 24 stamps of the (T, C) ``temperature``;
    ``hours``: its (T,) stamps, consecutive hours of whole days."""
    hours = np.asarray(hours, dtype="datetime64[h]")
    T = len(hours)
    whole = (T % 24 == 0 and hours[0] == hours[0].astype("datetime64[D]")
             and np.array_equal(hours, hours[0] + np.arange(T)))
    if not whole:
        raise ValueError("the reference takes consecutive hours of whole days from midnight")
    return temperature.reshape(T // 24, 24, -1).mean(dim=1)


def cell_values(f, lat, kwargs, hours):
    """(days, C) heat demand of a block of whole days; ``hours`` are the
    block's stamps."""
    del lat
    if kwargs.get("hour_shift", 0.0) != 0:
        raise ValueError("the reference takes hour_shift 0 only")
    t_day = daily_mean(f["temperature"], hours)
    demand = kwargs.get("a", 1.0) * (kwargs.get("threshold", 15.0) + KELVIN - t_day)
    return kwargs.get("constant", 0.0) + torch.clamp(demand, min=0.0)
