"""NCEP CFSR adapter — deprecated placeholder (counterpart
of ``atlite_tpu/datasets/ncep.py``).

The reference ships an un-ported, non-functional ncep module kept only as
a pattern reference (atlite's datasets/ncep.py:8-12, excluded
from the registry).  This framework mirrors that status: the module exists
for discoverability but raises on use.  The interesting behaviors it
modeled (un-averaging and de-accumulating forecast fields) are implemented
as array utilities below for reuse by future adapters.
"""

from __future__ import annotations

import numpy as np

crs = 4326
features: dict = {}
static_features: set = set()


def unaverage_forecast(values, steps_per_cycle=6):
    """Recover per-step means from cumulative-average forecast fields
    (pattern from reference ncep.py:71-90): given running means m_k over
    k steps, step value v_k = k*m_k - (k-1)*m_{k-1}."""
    v = np.asarray(values, dtype=float)
    T = v.shape[0]
    k = (np.arange(T) % steps_per_cycle) + 1
    kshape = (T,) + (1,) * (v.ndim - 1)
    k = k.reshape(kshape)
    prev = np.roll(v, 1, axis=0)
    prev[0] = 0
    out = k * v - (k - 1) * prev
    return out


def unaccumulate_forecast(values, steps_per_cycle=6):
    """Recover per-step values from within-cycle accumulations
    (pattern from reference ncep.py:92-110)."""
    v = np.asarray(values, dtype=float)
    out = v.copy()
    T = v.shape[0]
    in_cycle = np.arange(T) % steps_per_cycle != 0
    out[1:] = np.where(
        in_cycle[1:].reshape((-1,) + (1,) * (v.ndim - 1)), v[1:] - v[:-1], v[1:]
    )
    return out


def get_data(cutout, feature, **params):
    raise DeprecationWarning(
        "The ncep module is deprecated and un-ported (matching the "
        "reference, ncep.py:8-12); use module='era5' or 'synthetic'."
    )
