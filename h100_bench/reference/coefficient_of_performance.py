"""Reference of ``Cutout.coefficient_of_performance``: atlite's heat-pump
COP, ``c0 + c1 * dT + c2 * dT**2`` with ``dT = sink_T - source
temperature`` in degC, by the quadratic regressions of Staffell et al.
(2012) for an air and a ground (soil) source.  The soil temperature is
NaN over sea; atlite fills those cells' source temperature with 0 degC
(``fillna(0)``, so that they add nothing NaN to an aggregation), and so
does this reference.  No departure from atlite.
"""

from __future__ import annotations

import torch

KELVIN = 273.15
SOURCES = {"air": "temperature", "soil": "soil temperature"}
COEFFS = {"air": (6.81, -0.121, 0.000630), "soil": (8.77, -0.150, 0.000734)}
FIELDS = tuple(SOURCES.values())
DAILY = False
# relative L2 gap of a per-unit series; set from the readings in PERF.md
# section 6
LIMIT = 1e-4


def fields(kwargs):
    """The field a call with ``kwargs`` reads: its source's."""
    return (SOURCES[kwargs.get("source", "air")],)


def cell_values(f, lat, kwargs, hours=None):
    del lat, hours
    source = kwargs.get("source", "air")
    c0, c1, c2 = (d if kwargs.get(k) is None else kwargs[k]
                  for k, d in zip(("c0", "c1", "c2"), COEFFS[source]))
    source_T = f[SOURCES[source]] - KELVIN
    if source == "soil":
        source_T = torch.where(torch.isnan(source_T), torch.zeros_like(source_T), source_T)
    dT = kwargs.get("sink_T", 55.0) - source_T
    return c0 + c1 * dT + c2 * dT ** 2
