"""SARAH satellite irradiance adapter (counterpart of
``atlite_tpu/datasets/sarah.py``).

atlite's sarah module (its datasets/sarah.py:31-244): influx feature at
native 0.05 deg / 30 min resolution, with

- file discovery by date from the SARAH archive directory (sarah.py:42-89),
- decoding of the NetCDF archives via the port's own readers
  (``atlite_tpu_torch.io``, NETCDF4/HDF5 and NetCDF-3), including CF
  packed-integer unpacking (scale_factor / add_offset / _FillValue),
- NaN interpolation along time for the dawn/dusk gaps (sarah.py:91-132),
- pairwise stride-2 averaging 30 min -> 1 h for hourly cutouts
  (sarah.py:145-159),
- regridding onto the cutout resolution when it differs (sarah.py:226-227),
  through the port's ``gis/regrid.py``,
- diffuse = SIS - SID (sarah.py:229-231).

File dates and time alignment run on numpy ``datetime64[ns]`` (the JAX
package uses pandas' Series, ``to_datetime`` and ``get_indexer``): the
same files match and the same stamps miss.  ``get_filenames`` returns a
``Table`` (``to_pandas()`` gives the JAX package's DataFrame).

``get_data`` takes the archive directory via the ``sarah_dir`` creation
parameter (same name as atlite's, sarah.py:183-185); pre-decoded
arrays may still be passed via ``sarah_arrays`` ({"sis": (T2,Y,X),
"sid": (T2,Y,X), "x":..., "y":..., "time":...} at 30-min resolution).
"""

from __future__ import annotations

import glob
import logging
import os

import re

import numpy as np

from atlite_tpu_torch.core.timeutil import solar_ephemeris, to_datetime64
from atlite_tpu_torch.physics.solar import solar_position_numpy
from atlite_tpu_torch.table import Table

logger = logging.getLogger(__name__)

crs = 4326
dx = 0.05
dy = 0.05
dt = "30min"

features = {"influx": ["influx_direct", "influx_diffuse", "solar_altitude",
                       "solar_azimuth"]}
static_features = set()


# ---------------------------------------------------------------------------
# archive reading
# ---------------------------------------------------------------------------
_DATE = re.compile(r"SI.in(\d{8})")


def _file_date(path):
    """datetime64[ns] of the ``SI[SD]in<YYYYMMDD>`` stamp in a file name
    (NaT without one, or for a date that does not exist)."""
    m = _DATE.search(str(path))
    if m is None:
        return np.datetime64("NaT", "ns")
    d = m.group(1)
    try:
        return np.datetime64(f"{d[:4]}-{d[4:6]}-{d[6:]}", "ns")
    except ValueError:
        return np.datetime64("NaT", "ns")


def get_filenames(sarah_dir, time_index):
    """All SIS/SID files in ``sarah_dir`` covering the cutout's time span.

    Returns a Table with columns ``sis`` and ``sid`` indexed by file
    date — atlite's get_filenames (sarah.py:42-89): recursive glob, date
    parsed out of the ``SI[SD]in<YYYYMMDD>`` filename stem, inner join so
    only days with both variables survive, floor-to-day filter.
    """

    def _starting_with(name):
        pattern = os.path.join(str(sarah_dir), "**", f"{name}*.nc")
        files = glob.glob(pattern, recursive=True)
        if not files:
            raise FileNotFoundError(
                f"No files found at {pattern}. Make sure sarah_dir points "
                f"to the correct directory!"
            )
        dates = np.array([_file_date(f) for f in files], dtype="datetime64[ns]")
        order = np.argsort(dates, kind="stable")  # NaT sorts last
        return dates[order], [files[i] for i in order]

    found = {}
    for name in ("SIS", "SID"):
        dates, files = _starting_with(name)
        keys = dates.astype(np.int64)
        uniq, counts = np.unique(keys, return_counts=True)
        if (counts > 1).any():
            dup = sorted({np.datetime_as_string(np.datetime64(int(k), "ns"), unit="D")
                          .replace("-", "") for k in uniq[counts > 1]})
            raise ValueError(
                f"duplicate {name} files for date(s) {dup} "
                f"under {sarah_dir} (the archive scan is recursive — remove "
                "stray copies)")
        found[name] = dict(zip(keys.tolist(), files))
    both = sorted(set(found["SIS"]) & set(found["SID"]),
                  key=lambda k: (k == np.iinfo(np.int64).min, k))
    dates = np.array(both, dtype=np.int64).astype("datetime64[ns]")
    idx = to_datetime64(time_index)
    start, end = idx[0].astype("datetime64[D]"), idx[-1].astype("datetime64[D]")
    start, end = start.astype("datetime64[ns]"), end.astype("datetime64[ns]")
    if len(dates) and (start < dates[0] or end > dates[-1]):
        logger.error(
            "Files in %s do not cover the whole time span: %s until %s", sarah_dir,
            *(np.datetime_as_string(t, unit="s").replace("T", " ") for t in (start, end)),
        )
    keep = [i for i, d in enumerate(dates) if start <= d <= end]
    return Table({"sis": [found["SIS"][both[i]] for i in keep],
                  "sid": [found["SID"][both[i]] for i in keep]},
                 index=[dates[i] for i in keep])


def _unpack_cf(arr, attrs):
    """CF packed-integer decoding via the one shared implementation
    (io/netcdf.unpack_cf, which masks both _FillValue and missing_value);
    always returns float64 (SARAH archives store SIS/SID as scaled
    int16)."""
    from atlite_tpu_torch.io.netcdf import unpack_cf

    out, _ = unpack_cf(arr, dict(attrs or {}))
    return np.asarray(out, dtype=np.float64)


def open_archive(paths, var, extent):
    """Read ``var`` out of a sequence of SARAH NetCDF files and concatenate
    along time, cropped to ``extent`` (xmin, xmax, ymin, ymax) padded by
    0.01 deg, coords rounded to 4 decimals — the reference's
    open_mfdataset + sel + round (sarah.py:207-215).

    Returns (values (T,Y,X) float64 with ascending lat, lon, lat, times).
    """
    from atlite_tpu_torch.io.netcdf import read_netcdf

    lo_x, hi_x = extent[0] - 0.01, extent[1] + 0.01
    lo_y, hi_y = extent[2] - 0.01, extent[3] + 0.01
    pieces, times = [], []
    lon_out = lat_out = None
    for p in paths:
        _, variables, _ = read_netcdf(p)
        ren = {"longitude": "lon", "latitude": "lat"}
        coords = {ren.get(k, k): v for k, v in variables.items()
                  if ren.get(k, k) in ("lon", "lat", "time")}
        lon = np.round(np.asarray(coords["lon"][1], dtype=float), 4)
        lat = np.round(np.asarray(coords["lat"][1], dtype=float), 4)
        traw = np.asarray(coords["time"][1])
        if traw.dtype.kind != "M":
            # an undecoded numeric time would silently reinterpret raw
            # values as epoch NANOSECONDS (same guard as era5._open_raw)
            raise ValueError(
                f"{p}: undecodable time coordinate (units not CF-parsed)")
        t = traw.astype("datetime64[ns]")
        dnames, arr, vattrs = variables[var]
        vals = _unpack_cf(arr, vattrs)
        if vals.ndim == 2:
            vals = vals[None]
        # normalize axis order to (time, lat, lon)
        order = tuple(ren.get(d, d) for d in dnames)
        if order[-2:] == ("lon", "lat"):
            vals = np.swapaxes(vals, -1, -2)
        if len(lat) > 1 and lat[0] > lat[-1]:  # descending lat -> ascending
            lat = lat[::-1]
            vals = vals[:, ::-1]
        if len(lon) > 1 and lon[0] > lon[-1]:  # descending lon too
            lon = lon[::-1]
            vals = vals[:, :, ::-1]
        iy = np.where((lat >= lo_y) & (lat <= hi_y))[0]
        ix = np.where((lon >= lo_x) & (lon <= hi_x))[0]
        vals = vals[:, iy][:, :, ix]
        lon_c, lat_c = lon[ix], lat[iy]
        if lon_out is None:
            lon_out, lat_out = lon_c, lat_c
        elif (len(lon_c) != len(lon_out) or len(lat_c) != len(lat_out)
              or not np.allclose(lon_c, lon_out) or not np.allclose(lat_c, lat_out)):
            raise ValueError(f"{p}: SARAH files have inconsistent grids")
        pieces.append(vals)
        times.append(t)
    times = np.concatenate(times)
    order = np.argsort(times, kind="stable")
    values = np.concatenate(pieces, axis=0)[order]
    return values, lon_out, lat_out, times[order]


# ---------------------------------------------------------------------------
# array processing chain
# ---------------------------------------------------------------------------
def interpolate_nan_time(values: np.ndarray) -> np.ndarray:
    """Linear interpolation of NaNs along the leading time axis
    (sarah.py:91-132; fills interior gaps, keeps leading/trailing NaNs
    replaced by nearest valid value)."""
    v = np.asarray(values, dtype=float)
    T = v.shape[0]
    flat = v.reshape(T, -1)
    t = np.arange(T, dtype=float)
    out = flat.copy()
    nan_cols = np.where(np.isnan(flat).any(axis=0))[0]
    for j in nan_cols:
        col = flat[:, j]
        ok = ~np.isnan(col)
        if ok.sum() == 0:
            continue
        out[:, j] = np.interp(t, t[ok], col[ok])
    return out.reshape(v.shape)


def hourly_mean(values: np.ndarray) -> np.ndarray:
    """Pairwise stride-2 mean along time: 30 min -> 1 h (sarah.py:145-159)."""
    v = np.asarray(values, dtype=float)
    n = (v.shape[0] // 2) * 2
    return 0.5 * (v[0:n:2] + v[1:n:2])


def process_sarah(sis, sid, src_x, src_y, src_time, cutout, interpolate=True):
    """Full SARAH processing chain onto the cutout grid (sarah.py:162-243).

    Interpolate-or-fill, 30min->1h for hourly cutouts, regrid when the
    lattice differs, diffuse split, and the 0-h-shift solar position.
    """
    from atlite_tpu_torch.dataarray import DataArray
    from atlite_tpu_torch.gis.regrid import regrid

    grid = cutout.grid_desc
    if interpolate:
        sis = interpolate_nan_time(sis)
        sid = interpolate_nan_time(sid)
    else:
        sis = np.nan_to_num(sis, nan=0.0)  # reference fillna(0), sarah.py:219
        sid = np.nan_to_num(sid, nan=0.0)

    times = to_datetime64(src_time)
    if grid.dt not in ("30min", "30T"):  # hourly cutout (sarah.py:224-225)
        sis = hourly_mean(sis)
        sid = hourly_mean(sid)
        times = times[: 2 * sis.shape[0] : 2]

    src_x = np.asarray(src_x, dtype=float)
    src_y = np.asarray(src_y, dtype=float)
    same_lattice = (
        len(src_x) == len(grid.x) and len(src_y) == len(grid.y)
        and np.allclose(src_x, grid.x, atol=1e-4)
        and np.allclose(src_y, grid.y, atol=1e-4)
    )
    if not same_lattice:
        def _rg(v):
            da = DataArray(v, coords={"time": times, "y": src_y, "x": src_x},
                           dims=("time", "y", "x"))
            return regrid(da, grid.x, grid.y, resampling="average").values
        sis, sid = _rg(sis), _rg(sid)

    # align onto the cutout's time lattice
    want = to_datetime64(grid.time)
    if len(np.unique(times)) != len(times):
        raise ValueError("SARAH time stamps repeat: reindexing needs unique stamps")
    where = {t: i for i, t in enumerate(times.astype(np.int64).tolist())}
    pos = np.array([where.get(t, -1) for t in want.astype(np.int64).tolist()], dtype=np.int64)
    if (pos < 0).any():
        missing = want[pos < 0]
        raise ValueError(
            f"SARAH data lacks {len(missing)} requested timestamps "
            f"(first: {missing[0]})"
        )
    sis, sid = sis[pos], sid[pos]

    influx_diffuse = sis - sid
    eph = solar_ephemeris(grid.time, time_shift="0h")
    sp = solar_position_numpy(eph["declination"], eph["hour_angle0"], grid.x, grid.y)
    tyx = ("time", "y", "x")
    return {
        "influx_direct": (tyx, sid),
        "influx_diffuse": (tyx, influx_diffuse),
        "solar_altitude": (tyx, sp["altitude"]),
        "solar_azimuth": (tyx, sp["azimuth"]),
    }


def get_data(cutout, feature, tmpdir=None, **creation_parameters):
    """Load SARAH archives (or pre-decoded arrays) and reformat onto the
    cutout (reference get_data, sarah.py:162-243)."""
    interpolate = creation_parameters.get("sarah_interpolate", True)
    arrays = creation_parameters.get("sarah_arrays")
    if arrays is not None:
        return process_sarah(
            arrays["sis"], arrays["sid"], arrays["x"], arrays["y"],
            arrays["time"], cutout, interpolate=interpolate,
        )
    sarah_dir = creation_parameters.get("sarah_dir")
    if sarah_dir is None:
        raise ValueError(
            "The sarah module needs the 'sarah_dir' creation parameter "
            "(directory containing the SIS*/SID* NetCDF archives), or "
            "pre-decoded arrays via sarah_arrays={'sis', 'sid', 'x', 'y', "
            "'time'}."
        )
    grid = cutout.grid_desc
    if grid.dt not in ("30min", "30T", "h", "1h", "H"):
        raise ValueError(
            f"sarah supports 30min or hourly cutouts, got dt={grid.dt!r}"
        )
    files = get_filenames(sarah_dir, grid.time_index)
    extent = grid.extent
    sis, lon, lat, times = open_archive(files["sis"], "SIS", extent)
    sid, lon2, lat2, times2 = open_archive(files["sid"], "SID", extent)
    # SIS/SID files are paired only by filename date — verify the decoded
    # axes really align element-wise before subtracting (SIS - SID);
    # a shifted or mislabeled SID archive must fail loudly, not produce
    # silently wrong influx_direct/diffuse
    if len(times2) != len(times):
        raise ValueError(
            f"SIS and SID archives carry different numbers of time steps "
            f"({len(times)} vs {len(times2)})")
    if (times2 != times).any():
        first = times[int((times != times2).argmax())]
        raise ValueError(
            f"SIS and SID archives carry misaligned time stamps "
            f"(first mismatch at {first})")
    if (len(lon2) != len(lon) or len(lat2) != len(lat)
            or not np.allclose(lon, lon2, atol=1e-6)
            or not np.allclose(lat, lat2, atol=1e-6)):
        raise ValueError("SIS and SID archives are on different grids")
    return process_sarah(sis, sid, lon, lat, times, cutout,
                         interpolate=interpolate)
