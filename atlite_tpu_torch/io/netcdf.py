"""Unified NetCDF front door: magic-byte sniffing + CF time handling
(counterpart of ``atlite_tpu/io/netcdf.py``).

``read_netcdf`` accepts both NetCDF-3 classic files (CDF-1/CDF-2) and
NETCDF4 files (HDF5 container, as xarray's default engines write them:
what every atlite cutout is).  ``write_netcdf`` emits NetCDF-3
64-bit-offset, or NETCDF4 through ``hdf5_write``.

CF time runs on numpy ``datetime64[ns]``, without pandas: the epoch takes
the forms ``pd.Timestamp`` reads in CF units (unpadded fields as in
``1900-1-1``, a space or ``T`` before the time, fractional seconds, a
``Z``/``UTC``/``GMT`` or ``+hh:mm`` zone), and float offsets round to
whole nanoseconds as ``pd.to_timedelta`` rounds them (the fraction to as
many decimals as the unit has digits of nanoseconds, then truncated), so
a decoded time axis is the JAX package's to the nanosecond.
"""

from __future__ import annotations

import datetime
import re

import numpy as np

from atlite_tpu_torch.io import netcdf3

_EPOCH_UNITS = ("seconds", "minutes", "hours", "days")
_NS_PER = {"seconds": 10**9, "minutes": 60 * 10**9, "hours": 3600 * 10**9,
           "days": 86400 * 10**9}
_EPOCH = re.compile(
    r"(?:(\d{1,4})-(\d{1,2})-(\d{1,2})|(\d{4})(\d{2})(\d{2}))"
    r"(?:[ T]+(\d{1,2})(?::(\d{1,2})(?::(\d{1,2})(?:\.(\d+))?)?)?)?"
    r"\s*(Z|UTC|GMT|[+-]\d{1,2}(?::?\d{2})?)?")
_NS_MIN, _NS_MAX = -(2**63) + 1, 2**63 - 1  # datetime64[ns] (min int is NaT)


def _epoch_ns(epoch, naive=False):
    """Nanoseconds since 1970 of a CF epoch string, as pandas reads it;
    ``naive`` refuses a zone (pandas cannot subtract a zoned epoch from
    naive stamps)."""
    m = _EPOCH.fullmatch(epoch.strip())
    if m is None:
        raise ValueError(f"cannot parse CF epoch {epoch!r}")
    g = m.groups()
    y, mo, d = (int(v) for v in (g[0:3] if g[0] is not None else g[3:6]))
    hh, mi, ss = (int(v) if v is not None else 0 for v in g[6:9])
    frac = int((g[9] or "")[:9].ljust(9, "0"))
    day = datetime.date(y, mo, d)  # raises ValueError on a day past the month
    if hh > 23 or mi > 59 or ss > 59:
        raise ValueError(f"time out of range in CF epoch {epoch!r}")
    zone = g[10]
    if zone and naive:
        raise TypeError(f"cannot subtract the zoned epoch {epoch!r} from naive stamps")
    offset = 0
    if zone and zone[0] in "+-":
        digits = zone[1:].replace(":", "")
        offset = int(digits[:-2] or 0) * 60 + int(digits[-2:]) if len(digits) > 2 \
            else int(digits) * 60
        offset = -offset if zone[0] == "-" else offset
    days = (day - datetime.date(1970, 1, 1)).days
    ns = ((days * 24 + hh) * 60 + mi - offset) * 60 * 10**9 + ss * 10**9 + frac
    if not _NS_MIN <= ns <= _NS_MAX:
        raise ValueError(f"CF epoch {epoch!r} lies outside the datetime64[ns] range")
    return ns


def _offsets_ns(values, step):
    """int64 nanoseconds of float offsets in ``step`` units (NaN -> NaT's
    integer), rounded as ``pd.to_timedelta`` rounds them."""
    v = np.asarray(values, dtype=np.float64).reshape(-1)
    m = _NS_PER[step]
    nan = np.isnan(v)
    big = ~nan & ~(np.abs(v) < 2.0**63)
    if big.any():
        raise OverflowError(f"time offset {v[big][0]!r} does not fit an int64")
    base = np.where(nan, 0.0, v).astype(np.int64)  # truncates toward zero
    frac = np.where(nan, 0.0, v) - base
    # pandas rounds the fraction to log10(m) decimals, then truncates frac * m
    frac = np.round(frac, len(str(m)) - 1)
    limit = _NS_MAX // m
    if (np.abs(base) > limit).any():
        raise ValueError("time offsets run past the datetime64[ns] range")
    out = base * m + (frac * m).astype(np.int64)
    return np.where(nan, np.iinfo(np.int64).min, out), nan


def decode_cf_time(values, units, calendar=None):
    """CF 'X since Y' numeric time -> datetime64[ns] (host-side; device
    code never sees datetimes)."""
    if calendar is not None and str(calendar).lower() not in (
            "standard", "gregorian", "proleptic_gregorian"):
        # 360_day/noleap/julian cannot be represented as datetime64;
        # silently decoding them drifts days-to-weeks within a year
        raise NotImplementedError(f"CF calendar {calendar!r}")
    parts = units.split(" since ")
    if len(parts) != 2:
        raise ValueError(f"unsupported time units {units!r}")
    step, epoch = parts[0].strip().lower(), parts[1].strip()
    if step not in _EPOCH_UNITS:
        raise ValueError(f"unsupported time step {step!r}")
    origin = _epoch_ns(epoch)
    delta, nan = _offsets_ns(values, step)
    if (~nan).any() and not (_NS_MIN <= origin + int(delta[~nan].min())
                             and origin + int(delta[~nan].max()) <= _NS_MAX):
        raise ValueError(f"times of {units!r} run past the datetime64[ns] range")
    ns = np.where(nan, delta, delta + np.int64(origin))
    return ns.astype("datetime64[ns]").reshape(np.shape(values))


def encode_cf_time(times, units="hours since 1900-01-01"):
    origin = np.datetime64(_epoch_ns(units.split(" since ")[1].strip(), naive=True), "ns")
    step = units.split(" since ")[0].strip().lower()
    ns = (np.asarray(times).astype("datetime64[ns]") - origin).astype("timedelta64[ns]")
    return ns.astype("int64") / _NS_PER[step]


def unpack_cf(arr, vattrs):
    """Apply CF mask-and-scale (the xarray default): values equal to
    _FillValue/missing_value become NaN, then scale_factor/add_offset.
    Returns (array, attrs-with-packing-keys-removed); a no-op (same
    array) when no packing attrs are present.  Classic CDS NetCDF packs
    ERA5 fields as int16 with these attrs — using the raw integers is a
    silent misdecode."""
    vattrs = dict(vattrs or {})
    # mask BOTH codes, as xarray masks _FillValue and missing_value
    fills = [v for v in (vattrs.pop("_FillValue", None),
                         vattrs.pop("missing_value", None)) if v is not None]
    scale = vattrs.pop("scale_factor", None)
    offset = vattrs.pop("add_offset", None)
    if not fills and scale is None and offset is None:
        return arr, vattrs
    a = np.asarray(arr)
    out = a.astype(np.float64)
    for fill in fills:
        if a.dtype.kind not in "iuf":
            continue
        try:
            out = np.where(a == a.dtype.type(fill), np.nan, out)
        except (TypeError, ValueError, OverflowError):
            pass  # malformed fill attr: keep values rather than crash
    if scale is not None:
        out = out * float(scale)
    if offset is not None:
        out = out + float(offset)
    return out, vattrs


def read_netcdf(path, decode_times=True):
    """Read any supported NetCDF file.

    Returns (dims, variables, attrs) with ``variables`` mapping name ->
    (dim_names, array, attrs).  With decode_times, a 1-D coordinate
    variable whose units attr matches CF 'X since Y' becomes
    datetime64[ns].
    """
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic[:3] == b"CDF":
        dims, variables, attrs = netcdf3.read(path)
    elif magic == b"\x89HDF\r\n\x1a\n":
        from atlite_tpu_torch.io import hdf5

        dims, variables, attrs = hdf5.read_netcdf4(path)
    else:
        raise ValueError(f"{path}: not a recognized NetCDF file")
    if decode_times:
        out = {}
        for name, (dnames, arr, vattrs) in variables.items():
            units = vattrs.get("units")
            if (isinstance(units, str) and " since " in units
                    and np.asarray(arr).dtype.kind in "if"):
                try:
                    arr = decode_cf_time(arr, units, vattrs.get("calendar"))
                    vattrs = {k: v for k, v in vattrs.items()
                              if k not in ("units", "calendar")}
                except NotImplementedError:
                    # non-representable calendar (e.g. 360_day): keep the
                    # raw numbers + attrs rather than silently decoding
                    # them as proleptic-Gregorian or failing the file
                    pass
            out[name] = (dnames, arr, vattrs)
        variables = out
    return dims, variables, attrs


def write_netcdf(path, dims, variables, attrs=None, record_dim=None,
                 format="NETCDF3_64BIT", **kwargs):
    """Write a NetCDF file.

    format="NETCDF4" emits a compressed netCDF4/HDF5 file (atlite's
    on-disk cutout format, zlib complevel 4); "NETCDF3_64BIT" emits CDF-2.
    datetime64 arrays are CF-encoded as 'hours since 1900-01-01' (int64
    for NETCDF4 when lossless, float64 otherwise); NetCDF-3 additionally
    downcasts int64 to int32 when lossless (CDF-2 has no 64-bit integer
    type)."""
    netcdf4 = format.upper().startswith("NETCDF4")
    enc = {}
    for name, (dnames, arr, vattrs) in variables.items():
        arr = np.asarray(arr)
        vattrs = dict(vattrs or {})
        if arr.dtype.kind == "M":
            vattrs["units"] = "hours since 1900-01-01"
            vattrs["calendar"] = "proleptic_gregorian"
            arr = encode_cf_time(arr)
            if netcdf4:
                as64 = arr.astype(np.int64)
                if np.array_equal(as64, arr):
                    arr = as64
        elif arr.dtype.kind == "b":
            arr = arr.astype(np.int8)
        elif netcdf4:
            if arr.dtype == np.float16:
                arr = arr.astype(np.float32)
            # all other integer/float widths stored natively by HDF5
        elif arr.dtype == np.int64 or arr.dtype == np.uint32 \
                or arr.dtype == np.uint64:
            as32 = arr.astype(np.int32)
            arr = as32 if np.array_equal(as32, arr) else arr.astype(np.float64)
        elif arr.dtype == np.float16:
            arr = arr.astype(np.float32)
        elif arr.dtype == np.uint16:
            arr = arr.astype(np.int32)
        elif arr.dtype == np.uint8:
            arr = arr.astype(np.int16)
        enc[name] = (dnames, arr, vattrs)
    if netcdf4:
        from atlite_tpu_torch.io.hdf5_write import write_netcdf4

        write_netcdf4(path, dims, enc, attrs=attrs, **kwargs)
    else:
        netcdf3.write(path, dims, enc, attrs=attrs, record_dim=record_dim)
