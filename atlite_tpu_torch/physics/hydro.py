"""Hydro inflow routing (counterpart of ``atlite_tpu/physics/hydro.py``):
each plant's inflow is the sum of its upstream basins' runoff, each
delayed by the water's travel time.  The basin graph and geometry wait for
the GIS slice; these are the functions on arrays it will call.
"""

from __future__ import annotations

import numpy as np
import torch


def travel_hours(dist_main, plant_hid, upstream, flowspeed):
    """Water travel time from each upstream basin to the plant in whole
    hours: (distance difference in km) / (flowspeed in m/s * 3.6), rounded
    half up.  ``dist_main`` maps a basin id to its distance to the sea
    (a dict, or anything indexed by basin id)."""
    distances = (np.asarray([dist_main[h] for h in upstream], dtype=float)
                 - float(dist_main[plant_hid]))
    return (distances / (flowspeed * 3.6) + 0.5).astype(int)


def shift_and_aggregate(runoff, pair_plant, pair_basin, pair_shift, n_plants):
    """Per-plant inflow from rolled upstream-basin runoff.

    runoff: (B, T) basin runoff; pair_*: (P,) integer tensors, one entry a
    (plant, upstream basin) pair; returns (n_plants, T).  The value at
    hour t reads basin runoff at (t - shift) mod T, as ``np.roll`` does.
    """
    T = runoff.shape[1]
    as_idx = lambda a: torch.as_tensor(a, dtype=torch.int64, device=runoff.device)  # noqa: E731
    pair_plant, pair_basin, pair_shift = map(as_idx, (pair_plant, pair_basin, pair_shift))
    src = torch.remainder(torch.arange(T, device=runoff.device)[None, :] - pair_shift[:, None], T)
    gathered = runoff[pair_basin[:, None], src]  # (P, T)
    out = runoff.new_zeros((n_plants, T))
    return out.index_add_(0, pair_plant, gathered)
