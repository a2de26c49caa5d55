"""ERA5 adapter (counterpart of ``atlite_tpu/datasets/era5.py``).

The module contract of atlite's era5 module: ``crs``, ``features``,
``static_features`` and ``get_data(cutout, feature, ...)``, including the
request chunking (``retrieval_times``) and the variable derivations —
wind speed magnitude from u/v components, shear exponent, azimuth, J->W
flux conversion, albedo from net/downward radiation, geopotential->height,
and the -30 min solar-position merge.

Offline files (``era5_files=``, GRIB 1/2 or NetCDF) are decoded by the
port's own codecs (``atlite_tpu_torch.io``); without them ``get_data``
retrieves from the CDS through ``io/cds.py``.  The derivations run in
float64 numpy on the host, as in the JAX package, so a store prepared
from the same files is byte for byte the JAX package's; the time axis is
numpy ``datetime64[ns]`` throughout (no pandas).
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from atlite_tpu_torch.core.timeutil import calendar_fields, solar_ephemeris, to_datetime64
from atlite_tpu_torch.physics.solar import solar_position_numpy

logger = logging.getLogger(__name__)

crs = 4326

features = {
    "height": ["height"],
    "wind": ["wnd100m", "wnd_shear_exp", "wnd_azimuth", "roughness"],
    "influx": [
        "influx_toa",
        "influx_direct",
        "influx_diffuse",
        "albedo",
        "solar_altitude",
        "solar_azimuth",
    ],
    "temperature": ["temperature", "soil temperature", "dewpoint temperature"],
    "runoff": ["runoff"],
}

static_features = {"height"}

G0 = 9.80665  # standard gravity, for geopotential -> height (era5.py:65-81)


# ---------------------------------------------------------------------------
# pure derivations (unit-testable without CDS)
# ---------------------------------------------------------------------------
def derive_wind(u100, v100, u10, v10, fsr):
    """Wind variables from raw components (era5.py:104-135)."""
    wnd100m = np.sqrt(u100**2 + v100**2)
    wnd10m = np.sqrt(u10**2 + v10**2)
    shear = np.log(wnd10m / wnd100m) / np.log(10 / 100)
    azimuth = np.arctan2(u100, v100)
    azimuth = np.where(azimuth >= 0, azimuth, azimuth + 2 * np.pi)
    return {
        "wnd100m": wnd100m,
        "wnd_shear_exp": shear,
        "wnd_azimuth": azimuth,
        "roughness": fsr,
    }


def sanitize_wind(ds):
    """Roughness floor (era5.py:138-143)."""
    ds["roughness"] = np.where(ds["roughness"] >= 0.0, ds["roughness"], 2e-4)
    return ds


def derive_influx(ssrd, ssr, tisr, fdir, times, lon, lat):
    """Influx variables from raw radiation accumulations (era5.py:146-190)."""
    with np.errstate(invalid="ignore", divide="ignore"):
        albedo = (ssrd - ssr) / np.where(ssrd != 0, ssrd, np.nan)
    albedo = np.nan_to_num(albedo, nan=0.0)
    influx_diffuse = ssrd - fdir
    out = {
        "influx_toa": tisr / 3600.0,  # J m**-2 (1h accumulation) -> W m**-2
        "influx_direct": fdir / 3600.0,
        "influx_diffuse": influx_diffuse / 3600.0,
        "albedo": albedo,
    }
    # interval-center solar position (era5.py:178-188)
    eph = solar_ephemeris(times, time_shift="-30min")
    sp = solar_position_numpy(eph["declination"], eph["hour_angle0"], lon, lat)
    out["solar_altitude"] = sp["altitude"]
    out["solar_azimuth"] = sp["azimuth"]
    return out


def sanitize_influx(ds):
    """Clip negative fluxes (era5.py:193-199)."""
    for a in ("influx_direct", "influx_diffuse", "influx_toa"):
        ds[a] = np.clip(ds[a], 0.0, None)
    return ds


def sanitize_runoff(ds):
    ds["runoff"] = np.clip(ds["runoff"], 0.0, None)
    return ds


def derive_height(z):
    """Geopotential -> geopotential height (era5.py:65-81)."""
    return z / G0


# ---------------------------------------------------------------------------
# retrieval plumbing
# ---------------------------------------------------------------------------
def _area(grid):
    """[North, West, South, East] request area (era5.py:259-263)."""
    return [grid.y.max(), grid.x.min(), grid.y.min(), grid.x.max()]


def _unique(seq):
    """The distinct items of ``seq`` in their first order."""
    return list(dict.fromkeys(seq))


def retrieval_times(time_index, static=False, monthly_requests=False):
    """CDS request time chunking per year/month (era5.py:266-320)."""
    time = to_datetime64(time_index)
    f = calendar_fields(time)
    month = [f"{m:02d}" for m in f["month"]]
    day = [f"{d:02d}" for d in f["day"]]
    hour = [f"{h:02d}:00" for h in f["hour"]]
    if static:
        return {
            "year": [f"{f['year'][0]:04d}"],
            "month": [month[0]],
            "day": [day[0]],
            "time": hour[0],
        }
    queries = []
    for year in _unique(f["year"]):
        rows = np.flatnonzero(f["year"] == year)
        if monthly_requests:
            for m in _unique(f["month"][rows]):
                sub = rows[f["month"][rows] == m]
                queries.append({
                    "year": [str(year)],
                    "month": [month[sub[0]]],
                    "day": _unique(day[i] for i in sub),
                    "time": _unique(hour[i] for i in sub),
                })
        else:
            queries.append({
                "year": [str(year)],
                "month": _unique(month[i] for i in rows),
                "day": _unique(day[i] for i in rows),
                "time": _unique(hour[i] for i in rows),
            })
    return queries


# shortName -> CDS request variable name (reference era5.py:108-118,
# 151-157, 211-217, 237, 254)
CDS_NAMES = {
    "u10": "10m_u_component_of_wind",
    "v10": "10m_v_component_of_wind",
    "u100": "100m_u_component_of_wind",
    "v100": "100m_v_component_of_wind",
    "fsr": "forecast_surface_roughness",
    "ssr": "surface_net_solar_radiation",
    "ssrd": "surface_solar_radiation_downwards",
    "tisr": "toa_incident_solar_radiation",
    "fdir": "total_sky_direct_solar_radiation_at_surface",
    "t2m": "2m_temperature",
    "stl4": "soil_temperature_level_4",
    "d2m": "2m_dewpoint_temperature",
    "ro": "runoff",
    "z": "geopotential",
}
FEATURE_SHORTNAMES = {
    "wind": ["u10", "v10", "u100", "v100", "fsr"],
    "influx": ["ssr", "ssrd", "tisr", "fdir"],
    "temperature": ["t2m", "stl4", "d2m"],
    "runoff": ["ro"],
    "height": ["z"],
}
PRODUCT = "reanalysis-era5-single-levels"


def _open_raw(path):
    """Decode one downloaded/offline ERA5 file (GRIB 1/2 or NetCDF).

    Returns ({shortName: (T, Y, X) array}, coords) with ascending y and
    datetime64[ns] time (the local analog of the reference's
    open_with_grib_conventions + _rename_and_clean_coords,
    era5.py:84-101,352-429)."""
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic[:4] == b"GRIB" or b"GRIB" in magic:
        from atlite_tpu_torch.io import grib

        data, coords = grib.to_dataset(grib.read(path))
        return {k: v[1] for k, v in data.items()}, coords
    from atlite_tpu_torch.io.netcdf import read_netcdf

    dims, variables, _ = read_netcdf(path)
    ren = {"longitude": "x", "latitude": "y", "lon": "x", "lat": "y",
           "valid_time": "time"}
    coords, fields = {}, {}
    expver_vals = None
    for name, (dnames, arr, vattrs) in variables.items():
        name = ren.get(name, name)
        dnames = tuple(ren.get(d, d) for d in dnames)
        if name in ("x", "y", "time"):
            coords[name] = np.asarray(arr)
        elif name == "expver":
            # ERA5T bookkeeping: either a per-time label (new CDS layout,
            # nothing to merge) or a real dimension coordinate (old CDS
            # layout) whose values drive the merge below
            if dnames == ("expver",):
                expver_vals = np.asarray(arr)
            continue
        elif name == "number":
            continue  # ensemble bookkeeping coord (reference era5.py:101)
        elif set(dnames) >= {"y", "x"}:
            # CF mask-and-scale: classic CDS NetCDF packs fields as int16
            # with scale_factor/add_offset/_FillValue — raw integers would
            # be a silent misdecode and fill values must become NaN for
            # the expver hole-filling below to fire
            from atlite_tpu_torch.io.netcdf import unpack_cf

            arr, _ = unpack_cf(arr, vattrs)
            fields[name] = (dnames, np.asarray(arr, dtype=np.float64))
    for name, (dnames, arr) in list(fields.items()):
        if "expver" in dnames:
            ax = dnames.index("expver")
            fields[name] = (
                tuple(d for d in dnames if d != "expver"),
                _merge_expver(arr, ax, expver_vals),
            )
    y = coords["y"]
    flip = len(y) > 1 and y[0] > y[-1]
    out = {}
    for name, (dnames, arr) in fields.items():
        # collapse any remaining non-(time,y,x) dims (e.g. an ensemble
        # 'number' axis): squeeze singletons, refuse real extra axes —
        # leaving them in would flip/index the WRONG axis below
        extra = [d for d in dnames if d not in ("time", "y", "x")]
        for d in extra:
            ax = dnames.index(d)
            if arr.shape[ax] != 1:
                raise ValueError(
                    f"{path}: variable {name!r} carries unsupported "
                    f"dimension {d!r} (size {arr.shape[ax]})")
            arr = np.squeeze(arr, axis=ax)
            dnames = tuple(dd for dd in dnames if dd != d)
        if dnames[-2:] != ("y", "x"):
            order = [dnames.index(d) for d in ("time", "y", "x") if d in dnames]
            arr = np.transpose(arr, order)
        if arr.ndim == 2:
            arr = arr[None]
        if flip:
            arr = arr[:, ::-1]
        out[name] = arr
    coords["y"] = np.round(y[::-1] if flip else y, 5)
    coords["x"] = np.round(coords["x"], 5)
    if coords["time"].dtype.kind != "M":
        raise ValueError(f"{path}: undecodable time coordinate")
    return out, coords


def _merge_expver(arr, axis, expver_vals):
    """Collapse an ERA5/ERA5T ``expver`` dimension.

    Old-layout CDS NetCDF files carry variables shaped
    (time, expver, y, x) where each timestamp is valid in exactly one
    experiment version (NaN in the other): final ERA5 (expver 1/"0001")
    is preferred, then ERA5T (5/"0005"), elementwise first-non-NaN — the
    reference reaches the same result through cfgrib/xarray coordinate
    cleanup (era5.py:84-101, pinned by
    test_preparation_and_conversion.py:524-555)."""
    arr = np.moveaxis(np.asarray(arr, dtype=np.float64), axis, 0)
    n = arr.shape[0]

    def _rank(v):
        s = str(v.item() if hasattr(v, "item") else v)
        s = s.strip("b'\" ")
        try:
            return int(s)  # 1 (final ERA5) sorts before 5 (ERA5T)
        except ValueError:
            return 99

    order = (np.argsort([_rank(v) for v in expver_vals], kind="stable")
             if expver_vals is not None and len(expver_vals) == n
             else np.arange(n))
    out = arr[order[0]].copy()
    for i in order[1:]:
        hole = np.isnan(out)
        out[hole] = arr[i][hole]
    return out


def _concat_time(parts):
    """Merge per-request datasets along time (sorted, unique).

    Every part must sit on the SAME spatial lattice and carry the same
    variables — same-shape files over shifted areas would otherwise
    concatenate cleanly and land on the first file's coordinates
    (silent mis-georeferencing)."""
    fields = {}
    coords0 = parts[0][1]
    for i, (_, c) in enumerate(parts[1:], start=1):
        for ax in ("x", "y"):
            if (len(c[ax]) != len(coords0[ax])
                    or not np.allclose(np.asarray(c[ax], dtype=float),
                                       np.asarray(coords0[ax], dtype=float),
                                       atol=1e-5)):
                raise ValueError(
                    f"ERA5 file {i} sits on a different {ax} lattice than "
                    "file 0 — files passed together must share one grid")
    varsets = [set(p) for p, _ in parts]
    if any(vs != varsets[0] for vs in varsets[1:]):
        raise ValueError(
            "ERA5 files carry different variable sets "
            f"({sorted(set.union(*varsets) - set.intersection(*varsets))} "
            "not present everywhere); merge would silently drop them")
    times = np.concatenate([np.asarray(c["time"], dtype="datetime64[ns]")
                            for _, c in parts])
    order = np.argsort(times, kind="stable")
    uniq, first_idx = np.unique(times[order], return_index=True)
    sel = order[first_idx]
    for name in parts[0][0]:
        stacked = np.concatenate([p[name] for p, _ in parts], axis=0)
        fields[name] = stacked[sel]
    coords = dict(coords0)
    coords["time"] = uniq
    return fields, coords


def _indexer(have, want, name):
    have_r = np.round(np.asarray(have, dtype=float), 5)
    want_r = np.round(np.asarray(want, dtype=float), 5)
    pos = {v: i for i, v in enumerate(have_r)}
    try:
        return np.array([pos[v] for v in want_r], dtype=np.int64)
    except KeyError as exc:
        raise ValueError(
            f"ERA5 file does not cover the cutout's {name} lattice "
            f"(missing {exc.args[0]}; file has "
            f"[{have_r.min()}..{have_r.max()}])"
        ) from None


def _align(fields, coords, cutout_grid):
    """Select the cutout's lattice out of the decoded arrays (the
    reference relies on requesting the exact grid + rounded coords,
    era5.py:92-95; local files may cover a superset)."""
    iy = _indexer(coords["y"], cutout_grid.y, "y")
    ix = _indexer(coords["x"], cutout_grid.x, "x")
    want_t = np.asarray(cutout_grid.time, dtype="datetime64[ns]")
    have_t = np.asarray(coords["time"], dtype="datetime64[ns]")
    tpos = {v: i for i, v in enumerate(have_t)}
    missing = [str(t) for t in want_t if t not in tpos]
    if missing:
        raise ValueError(
            f"ERA5 file lacks {len(missing)} requested timestamps "
            f"(first: {missing[0]})"
        )
    it = np.array([tpos[t] for t in want_t], dtype=np.int64)
    return {k: v[it][:, iy][:, :, ix] for k, v in fields.items()}


def _retrieve_feature(cutout, shorts, tmpdir, monthly_requests,
                      concurrent_requests, static, data_format="grib",
                      product=PRODUCT):
    """Download via the CDS API and decode (reference retrieve_data,
    era5.py:432-517)."""
    import tempfile

    from atlite_tpu_torch.io import cds

    grid = cutout.grid_desc
    client = cds.Client()
    time_index = grid.time_index
    chunks = retrieval_times(time_index, static=static,
                             monthly_requests=monthly_requests)
    if isinstance(chunks, dict):
        chunks = [chunks]
    tmpdir = tmpdir or tempfile.gettempdir()

    def fetch(req):
        request = {
            "product_type": ["reanalysis"],
            "download_format": "unarchived",
            "data_format": data_format,
            "variable": [CDS_NAMES[s] for s in shorts],
            "area": _area(grid),
            "grid": [abs(float(grid.dx)), abs(float(grid.dy))],
            **req,
        }
        fd, target = tempfile.mkstemp(suffix=f".{data_format}", dir=tmpdir)
        import os

        os.close(fd)
        logger.info("CDS: downloading %s (%s)", shorts, req.get("year"))
        with cds.file_lock(target):
            client.retrieve(product, request, target)
        return _open_raw(target)

    parts = cds.map_requests(fetch, chunks, concurrent=concurrent_requests)
    return _concat_time(parts) if len(parts) > 1 else parts[0]


def get_data(cutout, feature, tmpdir=None, monthly_requests=False,
             concurrent_requests=False, sanitize=True, era5_files=None,
             **creation_parameters):
    """Load/retrieve and derive one ERA5 feature (reference get_data,
    era5.py:520-599).

    ``era5_files`` (also honored as a cutout attr): path / glob / list of
    pre-downloaded ERA5 GRIB or NetCDF files for fully offline operation —
    decoded with the self-contained codecs in atlite_tpu_torch.io.  Without it,
    the data is retrieved from the CDS API (credentials required).
    """
    import glob as _glob

    era5_files = era5_files or creation_parameters.get("era5_files")
    if feature not in FEATURE_SHORTNAMES:
        raise ValueError(f"unknown ERA5 feature {feature!r} "
                         f"(have {sorted(FEATURE_SHORTNAMES)})")
    shorts = FEATURE_SHORTNAMES[feature]
    static = feature in static_features
    grid = cutout.grid_desc

    if era5_files:
        if isinstance(era5_files, (str, Path)):
            matches = sorted(_glob.glob(str(era5_files)))
            paths = matches if matches else [era5_files]
        else:
            paths = list(era5_files)
        parts = [_open_raw(p) for p in paths]
        fields, coords = _concat_time(parts) if len(parts) > 1 else parts[0]
        missing = [s for s in shorts if s not in fields]
        if missing:
            raise ValueError(
                f"ERA5 files lack variables {missing} for feature "
                f"'{feature}' (have {sorted(fields)})"
            )
        if static:
            # static fields: take the first available timestamp
            fields = {k: v for k, v in fields.items() if k in shorts}
            sub = {k: _align_static(v, coords, grid) for k, v in fields.items()}
        else:
            sub = _align({k: fields[k] for k in shorts}, coords, grid)
    else:
        fields, coords = _retrieve_feature(
            cutout, shorts, tmpdir, monthly_requests, concurrent_requests,
            static, data_format=creation_parameters.get("data_format", "grib"),
        )
        if static:
            sub = {k: _align_static(fields[k], coords, grid) for k in shorts}
        else:
            sub = _align({k: fields[k] for k in shorts}, coords, grid)

    times = grid.time_index
    lon, lat = np.asarray(grid.x), np.asarray(grid.y)

    if feature == "wind":
        # NB: no wnd10m here — the reference's wind feature carries only
        # [wnd100m, wnd_shear_exp, wnd_azimuth, roughness]
        # (era5.py:47-60); a wnd10m entry would be dropped by the feature
        # filter anyway
        ds = derive_wind(sub["u100"], sub["v100"], sub["u10"], sub["v10"],
                         sub["fsr"])
        if sanitize:
            ds = sanitize_wind(ds)
    elif feature == "influx":
        ds = derive_influx(sub["ssrd"], sub["ssr"], sub["tisr"], sub["fdir"],
                           times, lon, lat)
        if sanitize:
            ds = sanitize_influx(ds)
    elif feature == "temperature":
        ds = {
            "temperature": sub["t2m"],
            "soil temperature": sub["stl4"],
            "dewpoint temperature": sub["d2m"],
        }
    elif feature == "runoff":
        ds = {"runoff": sub["ro"]}
        if sanitize:
            ds = sanitize_runoff(ds)
    else:  # feature == "height" (the name was validated up front)
        ds = {"height": derive_height(sub["z"])}

    out = {}
    for name, arr in ds.items():
        # no dtype cast here: Cutout.prepare stores at the cutout's own
        # dtype (a float64 cutout keeps f64 for oracle fixtures)
        arr = np.asarray(arr)
        dims = ("y", "x") if arr.ndim == 2 else ("time", "y", "x")
        out[name] = (dims, arr)
    return out


def _align_static(arr, coords, grid):
    """Static (height) fields: first available time slice on the cutout
    lattice (static features request one timestamp, era5.py:266-279)."""
    iy = _indexer(coords["y"], grid.y, "y")
    ix = _indexer(coords["x"], grid.x, "x")
    return np.asarray(arr)[0][iy][:, ix]
