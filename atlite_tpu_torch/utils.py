"""Small utilities (counterpart of ``atlite_tpu/utils.py``; atlite's
utils.py), without pandas: ``ensure_coords`` reads a pandas index by its
attributes, and ``timeindex_from_slice`` returns ``datetime64[ns]``."""

from __future__ import annotations

import calendar
import logging

import numpy as np

from atlite_tpu_torch.core.grid import _timestamp
from atlite_tpu_torch.core.timeutil import calendar_fields
from atlite_tpu_torch.resource import arrowdict  # noqa: F401  (re-export, utils.py:104)

logger = logging.getLogger(__name__)


class CachedAttribute:
    """Descriptor caching a computed attribute on first access
    (atlite utils.py:128-155)."""

    def __init__(self, method, name=None, doc=None):
        self.method = method
        self.name = name or method.__name__
        self.__doc__ = doc or method.__doc__

    def __get__(self, inst, cls):
        if inst is None:
            return self
        result = self.method(inst)
        inst.__dict__[self.name] = result
        return result


def migrate_from_cutout_directory(old_cutout_dir, path, device=None):
    """Convert an old-style (pre-v0.2 atlite) cutout directory — one
    NetCDF per month plus a ``meta.nc`` — into a single new-style cutout
    file (atlite utils.py:39-101), using the port's NetCDF decoders.

    Returns the migrated Cutout (opened from ``path`` on ``device``)."""
    from pathlib import Path

    from atlite_tpu_torch.core.grid import Grid
    from atlite_tpu_torch.cutout import Cutout, _read_netcdf_cutout
    from atlite_tpu_torch.datasets import modules as datamodules
    from atlite_tpu_torch.io.netcdf import read_netcdf

    old_cutout_dir = Path(old_cutout_dir)
    _, _, meta_attrs = read_netcdf(old_cutout_dir / "meta.nc")
    module = meta_attrs["module"]

    monthly = sorted(p for p in old_cutout_dir.glob("[12]*.nc"))
    if not monthly:
        raise FileNotFoundError(
            f"no monthly [12]*.nc files found in {old_cutout_dir}"
        )
    parts = [_read_netcdf_cutout(p) for p in monthly]
    # combine by coords along time (atlite uses open_mfdataset
    # combine='by_coords', utils.py:71-73)
    order = np.argsort([p[0]["time"][0] for p in parts])
    parts = [parts[i] for i in order]
    g0 = parts[0][0]
    for gk, _, _, _ in parts[1:]:
        if not (np.array_equal(gk["x"], g0["x"])
                and np.array_equal(gk["y"], g0["y"])):
            raise ValueError("monthly cutout files have mismatched grids")
    times = np.concatenate([p[0]["time"] for p in parts])
    data, var_attrs = {}, {}
    for name in parts[0][1]:
        dims = tuple(parts[0][3][name].get("dims", ("time", "y", "x")))
        if "time" in dims:
            axis = dims.index("time")
            data[name] = np.concatenate([p[1][name] for p in parts], axis=axis)
        else:
            data[name] = parts[0][1][name]
        var_attrs[name] = dict(parts[0][3][name])

    attrs = {k: v for k, v in meta_attrs.items() if k != "prepared_features"}
    attrs["module"] = module
    attrs["prepared_features"] = list(datamodules[module].features)
    for name in data:
        fd = datamodules[module].features.items()
        features = [k for k, l in fd if name in l]
        var_attrs[name]["module"] = module
        var_attrs[name]["feature"] = features.pop() if features else "undefined"

    path = Path(path).with_suffix(".nc")
    cutout = Cutout(
        data=data, grid_desc=Grid(x=g0["x"], y=g0["y"], time=times, crs=4326),
        attrs=attrs, var_attrs=var_attrs, device=device,
    )
    cutout.to_netcdf(path)
    logger.info("Writing cutout data to %s. When done, load it again using "
                "atlite_tpu_torch.Cutout(%r)", path, str(path))
    return Cutout(path, device=device)


def ensure_coords(index):
    """Normalize an index / mapping into a ``{name: index}`` coords dict
    (atlite utils.py:22-36).  A pandas Index or MultiIndex (known by its
    ``nlevels`` and ``name``, pandas is not imported) is kept as given; a
    mapping's values become numpy arrays."""
    if hasattr(index, "nlevels") and hasattr(index, "name"):
        return {index.name or "dim_0": index}
    if isinstance(index, dict):
        return {k: np.asarray(v) for k, v in index.items()}
    raise ValueError(
        f"index must be a pandas index or a coords mapping, not: {index}"
    )


def timeindex_from_slice(timeslice):
    """Hourly ``datetime64[ns]`` stamps from the start of a slice of date
    strings to one calendar month past its stop, the end excluded (atlite
    utils.py:99-101; a day past the next month's end falls on its last)."""
    stop = _timestamp(timeslice.stop)
    f = {k: int(v[0]) for k, v in calendar_fields(stop).items()}
    year, month0 = divmod(f["year"] * 12 + f["month"], 12)  # one month on, from 0
    month = month0 + 1
    day = min(f["day"], calendar.monthrange(year, month)[1])
    end = (np.datetime64(f"{year:04d}-{month:02d}-{day:02d}", "ns")
           + (stop - stop.astype("datetime64[D]")))
    return np.arange(_timestamp(timeslice.start), end, np.timedelta64(1, "h"))


def maybe_tqdm(iterable, **kwargs):
    """tqdm progress bar when available and enabled, else passthrough."""
    if not kwargs.pop("enable", True):
        return iterable
    try:
        from tqdm import tqdm

        return tqdm(iterable, **kwargs)
    except ImportError:
        return iterable
