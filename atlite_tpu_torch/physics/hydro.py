"""Hydro inflow routing (counterpart of ``atlite_tpu/physics/hydro.py``):
each plant's inflow is the sum of its upstream basins' runoff, each
delayed by the water's travel time.

The host half finds each plant's basin, its upstream basins (a breadth-
first search over ``NEXT_DOWN``) and their areas; ``shift_and_aggregate``
then rolls and sums the basins' runoff on the device.  Plants and basins
come as a pandas DataFrame or a dict of equal-length columns, read
duck-typed (``obj["col"]`` and an optional ``.index``): the port imports
no pandas.
"""

from __future__ import annotations

import logging
from collections import namedtuple

import numpy as np
import torch

from atlite_tpu_torch.core.device import resolve_device
from atlite_tpu_torch.dataarray import DataArray
from atlite_tpu_torch.gis.geometry import parse_geometry, transform_geometry

logger = logging.getLogger(__name__)

# plants: {"index": labels, "hid": [basin id], "upstream": [[basin ids]]};
# meta: {column: {basin id: value}} of the upstream basins; shapes:
# {basin id: geometry}, in the order the basins first appear upstream
Basins = namedtuple("Basins", ["plants", "meta", "shapes"])


def _columns(table):
    return list(table.columns) if hasattr(table, "columns") else list(table)


def _labels(table, n):
    """A table's own row labels, else 0..n-1."""
    index = getattr(table, "index", None)
    return np.arange(n) if index is None or callable(index) else index


def find_basin(shapes, lon, lat):
    """The id of the basin that holds the point; the first of several,
    with a warning; ValueError for none.  ``shapes``: {basin id:
    geometry}, or anything with such ``.items()``."""
    hids = [hid for hid, geom in shapes.items()
            if parse_geometry(geom).contains_point(lon, lat)]
    if len(hids) > 1:
        logger.warning(f"The point ({lon}, {lat}) is in several basins: {hids}. "
                       "Assuming the first one.")
    if not hids:
        raise ValueError(f"No basin found for point ({lon}, {lat})")
    return hids[0]


def find_upstream_basins(next_down, hid):
    """The basin and every basin upstream of it, breadth first, the
    children of a basin in the table's order.  ``next_down``: {basin id:
    id of the basin downstream}, or anything with such ``.items()``."""
    return _upstream(_children(next_down), hid)


def _children(next_down):
    """{basin id: the ids draining into it, in the table's order}."""
    children = {}
    for h, down in next_down.items():
        children.setdefault(down, []).append(h)
    return children


def _upstream(children, hid):
    hids = [hid]
    i = 0
    while i < len(hids):
        hids.extend(children.get(hids[i], ()))
        i += 1
    return hids


def determine_basins(plants, hydrobasins, show_progress=False):
    """Each plant's basin and its upstream basins.

    plants: columns ``lon``, ``lat``; hydrobasins: columns ``HYBAS_ID``,
    ``DIST_MAIN`` (km to the outlet), ``NEXT_DOWN`` and ``geometry``
    (engine geometries or ``__geo_interface__`` objects).
    """
    del show_progress
    missing = {"HYBAS_ID", "DIST_MAIN", "NEXT_DOWN", "geometry"}.difference(
        _columns(hydrobasins))
    if missing:
        # the JAX package asserts this
        raise AssertionError(f"Couldn't find the column(s) {', '.join(missing)} in the "
                             "hydrobasins dataset.")
    ids = list(np.asarray(hydrobasins["HYBAS_ID"]).tolist())
    geoms = [parse_geometry(g) for g in hydrobasins["geometry"]]
    shapes = dict(zip(ids, geoms))
    meta = {c: dict(zip(ids, np.asarray(hydrobasins[c]).tolist()))
            for c in sorted(_columns(hydrobasins)) if c not in ("HYBAS_ID", "geometry")}
    # a point outside a basin's bounding box is outside the basin: test
    # only the basins whose box holds it, in the table's order
    bounds = np.array([g.bounds for g in geoms]).reshape(-1, 4)
    lon = np.asarray(plants["lon"], dtype=float)
    lat = np.asarray(plants["lat"], dtype=float)
    children = _children(meta["NEXT_DOWN"])
    hid, upstream = [], []
    for x, y in zip(lon.tolist(), lat.tolist()):
        near = np.flatnonzero((bounds[:, 0] <= x) & (x <= bounds[:, 2])
                              & (bounds[:, 1] <= y) & (y <= bounds[:, 3]))
        h = find_basin({ids[i]: geoms[i] for i in near}, x, y)
        hid.append(h)
        upstream.append(_upstream(children, h))
    unique = list(dict.fromkeys(b for ups in upstream for b in ups))
    return Basins({"index": _labels(plants, len(lon)), "hid": hid, "upstream": upstream},
                  {c: {h: col[h] for h in unique} for c, col in meta.items()},
                  {h: shapes[h] for h in unique})


def basin_areas_m2(basins):
    """Basin areas on the equal-area cylindrical projection [m^2]."""
    return np.asarray([transform_geometry(parse_geometry(g), 4326, "cea").area
                       for g in basins.shapes.values()])


def inflow_for_plants(basins, runoff_da, flowspeed=1, device=None, dtype=None):
    """Per-plant inflow (plant, time) from the (basin, time) runoff of
    ``basins.shapes``' order: each upstream basin's series rolled by its
    travel time and summed on ``device`` (default: the CUDA card), in
    ``dtype`` (default: the runoff's)."""
    pos = {h: i for i, h in enumerate(basins.shapes)}
    pair_plant, pair_basin, pair_shift = [], [], []
    for pi, (hid, ups) in enumerate(zip(basins.plants["hid"], basins.plants["upstream"])):
        nhours = travel_hours(basins.meta["DIST_MAIN"], hid, ups, flowspeed)
        pair_plant += [pi] * len(ups)
        pair_basin += [pos[b] for b in ups]
        pair_shift += nhours.tolist()
    values = runoff_da.values
    if not isinstance(values, torch.Tensor):
        values = torch.as_tensor(np.asarray(values))
    values = values.to(device=resolve_device(device), dtype=dtype or values.dtype)
    inflow = shift_and_aggregate(values, pair_plant, pair_basin, pair_shift,
                                 len(basins.plants["hid"]))
    return DataArray(inflow.cpu().numpy(),
                     coords={"plant": basins.plants["index"], "time": runoff_da.coords["time"]},
                     dims=("plant", "time"))


def shift_and_aggregate_runoff_for_plants(basins, runoff, flowspeed=1, show_progress=False,
                                          device=None):
    """``inflow_for_plants`` under atlite's name; ``show_progress`` is
    accepted and unused."""
    del show_progress
    return inflow_for_plants(basins, runoff, flowspeed, device=device)


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
