"""Temperature-derived converters (counterpart of
``atlite_tpu/physics/thermal.py``): ambient, soil and dewpoint temperature,
heat-pump COP, degree-day heat/cooling demand from daily means, and
solar-thermal collector output, on tensors.
"""

from __future__ import annotations

import torch

KELVIN = 273.15

COP_COEFFS = {
    # quadratic COP regressions, Staffell et al. 2012
    "air": (6.81, -0.121, 0.000630),
    "soil": (8.77, -0.150, 0.000734),
}


def temperature_celsius(fields):
    """K -> degC."""
    return fields["temperature"] - KELVIN


def soil_temperature_celsius(fields):
    """K -> degC with the sea's NaN cells zeroed."""
    return torch.nan_to_num(fields["soil temperature"] - KELVIN, nan=0.0)


def dewpoint_temperature_celsius(fields):
    """K -> degC."""
    return fields["dewpoint temperature"] - KELVIN


def coefficient_of_performance(source_T, sink_T, c0, c1, c2):
    """COP = c0 + c1*dT + c2*dT^2 with dT = sink - source."""
    delta_T = sink_T - source_T
    return c0 + c1 * delta_T + c2 * delta_T**2


def daily_mean(field, group_ids, n_days):
    """Mean over each day along the leading time axis: ``group_ids`` (T,)
    maps each hour to its day; sums and counts by ``index_add_``."""
    ids = torch.as_tensor(group_ids, dtype=torch.int64, device=field.device)
    sums = field.new_zeros((n_days,) + tuple(field.shape[1:])).index_add_(0, ids, field)
    counts = field.new_zeros(n_days).index_add_(0, ids, field.new_ones(field.shape[0]))
    return sums / counts[(...,) + (None,) * (field.ndim - 1)]


def degree_day_demand(daily_T, threshold, a, constant, kind):
    """Degree-day heat/cooling demand from daily-mean temperature [K];
    ``threshold`` in degC."""
    thr = threshold + KELVIN
    demand = a * (thr - daily_T) if kind == "heat" else a * (daily_T - thr)
    return constant + torch.clamp(demand, min=0.0)


def solar_thermal_output(irradiation, temperature, c0, c1, t_store):
    """Collector output G * (c0 - c1 * (T_store - T_amb) / G), negative
    output zeroed; a zero irradiance gives a loss ratio of 0.  ``t_store``
    in degC, ``temperature`` in K."""
    ratio = torch.nan_to_num(
        (t_store + KELVIN - temperature)
        / torch.where(irradiation != 0, irradiation, torch.nan),
        nan=0.0)
    output = irradiation * (c0 - c1 * ratio)
    return torch.where(output > 0.0, output, 0.0)
