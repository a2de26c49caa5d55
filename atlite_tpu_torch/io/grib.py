"""GRIB edition 1 + edition 2 codec, pure Python (no eccodes/cfgrib).

ERA5 from the CDS/MARS archive ships as GRIB **edition 1** with ECMWF
local parameter tables (the reference decodes it through cfgrib/eccodes,
atlite's datasets/era5.py:352-429); the CDS "netcdf" option
is handled by atlite_tpu_torch.io.netcdf.  This module implements:

- GRIB1: full decode of the ERA5 subset — PDS with ECMWF local
  definitions, lat/lon + Gaussian GDS (grid type 4, incl. reduced grids
  with PL lists), bitmap section, simple packing with IBM-370 32-bit
  reference floats and sign-magnitude integers — plus an encoder used
  for test fixtures and offline round-trips.
- GRIB2: sections 0-8 with grid templates 3.0 (regular lat/lon) and
  3.40 (regular + reduced Gaussian), product templates 4.0/4.8/4.11
  (+4.1/4.2 prefix), data representations 5.0 (simple packing), 5.4
  (raw IEEE), 5.40 (JPEG2000 via libopenjp2 — eccodes' grib_jpeg),
  5.41 (PNG packing, Pillow-validated io/png.py) and 5.42 (CCSDS/AEC
  via libaec — eccodes' grib_ccsds) decode + encode, and 5.2/5.3
  (complex packing / spatial differencing) decode.

Format layouts follow the public WMO FM 92 GRIB specifications.

The port's copy of ``atlite_tpu/io/grib.py``: the same records from the
same bytes and the same bytes from the same records
(``tests/test_torch_grib.py``).  Only the bit (un)packing differs in
formulation: values are read through a 40-bit window gathered a value at a
time (a big-endian view where the width is a whole number of bytes)
instead of a (count, nbits) bit matrix, which at the width of one ERA5
field over Europe cost ~15 MB and most of the decode time a message.
"""

from __future__ import annotations

import functools
import logging
import struct

import numpy as np

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# shared bit utilities
# ---------------------------------------------------------------------------


def _unpack_bits(buf, nbits, count, bit_offset=0):
    """Unpack `count` big-endian unsigned ints of width nbits."""
    if count < 0 or count > 100_000_000:
        raise ValueError(f"implausible GRIB point count {count}")
    if nbits > 32:
        # real GRIB packing tops out at 24-32 bits; beyond 63 the int64
        # weights overflow to SILENT zeros — refuse, never misdecode
        raise ValueError(f"implausible GRIB packing width {nbits} bits")
    if nbits == 0:
        return np.zeros(count, dtype=np.int64)
    a = np.frombuffer(buf, dtype=np.uint8)
    total = bit_offset + nbits * count
    nbytes = (total + 7) // 8
    if nbytes > len(a):
        raise ValueError(
            f"GRIB data section too short: need {nbytes} bytes for "
            f"{count} x {nbits}-bit values, have {len(a)}")
    a = a[:nbytes]
    if nbits == 1:
        return np.unpackbits(a)[bit_offset:total].astype(np.int64)
    if bit_offset % 8 == 0 and nbits in (8, 16, 32):
        start = bit_offset // 8
        view = np.frombuffer(a.tobytes()[start:start + nbits // 8 * count],
                             dtype=f">u{nbits // 8}")
        return view.astype(np.int64)
    # a 40-bit big-endian window at each value's first byte holds the
    # value whole (a 32-bit value starts at most 7 bits into it)
    padded = np.zeros(nbytes + 5, dtype=np.uint64)
    padded[:nbytes] = a
    start = bit_offset + np.arange(count, dtype=np.int64) * nbits
    byte = start >> 3
    window = np.zeros(count, dtype=np.uint64)
    for k in range(5):
        window = (window << np.uint64(8)) | padded[byte + k]
    shift = (40 - nbits - (start & 7)).astype(np.uint64)
    return ((window >> shift) & np.uint64((1 << nbits) - 1)).astype(np.int64)


def _pack_bits(values, nbits):
    """Pack unsigned ints into a big-endian bitstream, zero-padded."""
    if nbits == 0:
        return b""
    v = np.asarray(values, dtype=np.int64)
    if nbits % 8 == 0:
        # whole bytes: the low nbits/8 bytes of each big-endian int64
        width = nbits // 8
        return v.astype(">u8").view(np.uint8).reshape(-1, 8)[:, 8 - width:].tobytes()
    bits = ((v[:, None] >> np.arange(nbits - 1, -1, -1, dtype=np.int64)) & 1)
    return np.packbits(bits.astype(np.uint8).ravel()).tobytes()


def _ibm32_decode(b):
    """IBM System/370 32-bit float (GRIB1 reference values)."""
    w = int.from_bytes(b, "big")
    sign = -1.0 if (w >> 31) else 1.0
    exponent = (w >> 24) & 0x7F
    mantissa = w & 0xFFFFFF
    return sign * mantissa * 16.0 ** (exponent - 64) / 2**24


def _ibm32_encode(x):
    if x == 0:
        return b"\x00\x00\x00\x00"
    sign = 0x80000000 if x < 0 else 0
    x = abs(x)
    # find e with mantissa in [1/16, 1): x = m * 16^(e-64), m*2^24 int
    import math

    e = int(math.ceil(math.log(x, 16))) + 64
    m = int(round(x / 16.0 ** (e - 64) * 2**24))
    while m >= 2**24:
        m >>= 4
        e += 1
    while m and m < 2**20:  # normalize
        m <<= 4
        e -= 1
    return struct.pack(">I", sign | (e << 24) | m)


def _sm16(b):
    """GRIB1 16-bit sign-magnitude integer."""
    v = int.from_bytes(b, "big")
    return -(v & 0x7FFF) if (v & 0x8000) else v


def _sm16_encode(v):
    return struct.pack(">H", (0x8000 | -v) if v < 0 else v)


def _sm24(b):
    v = int.from_bytes(b, "big")
    return -(v & 0x7FFFFF) if (v & 0x800000) else v


def _sm24_encode(v):
    u = (0x800000 | -v) if v < 0 else v
    return u.to_bytes(3, "big")


# ---------------------------------------------------------------------------
# GRIB1
# ---------------------------------------------------------------------------
# (table2Version, indicatorOfParameter) -> ERA5 shortName
GRIB1_PARAMS = {
    (128, 129): "z", (128, 165): "u10", (128, 166): "v10",
    (228, 246): "u100", (228, 247): "v100", (128, 244): "fsr",
    (128, 167): "t2m", (128, 236): "stl4", (128, 168): "d2m",
    (128, 176): "ssr", (128, 169): "ssrd", (128, 212): "tisr",
    (228, 21): "fdir", (128, 205): "ro",
}
GRIB1_PARAMS_INV = {v: k for k, v in GRIB1_PARAMS.items()}


# ---------------------------------------------------------------------------
# Gaussian grids (ERA5's native N320 reduced grid; reference gets these
# decoded by eccodes/cfgrib, atlite's datasets/era5.py:352-429)
# ---------------------------------------------------------------------------
def gaussian_latitudes(n_half):
    """The 2N Gaussian latitudes of an N-grid in degrees, north->south:
    arcsin of the roots of the Legendre polynomial P_2N, found by Newton
    iteration on the three-term recurrence (float64; N320 values match
    the published ECMWF tables to ~1e-12 deg; pinned against
    numpy.polynomial.legendre.leggauss in tests/test_grib.py).

    Memoized: ~16 ms per N320 computation x one call per message would
    dominate a year of reduced-Gaussian GRIB decode."""
    return _gaussian_latitudes_cached(int(n_half)).copy()


@functools.lru_cache(maxsize=8)
def _gaussian_latitudes_cached(n_half):
    n = 2 * int(n_half)
    if n <= 0 or n_half > 5000:  # highest real grids are O1280/N640
        raise ValueError(f"bad Gaussian N {n_half}")
    i = np.arange(1, n + 1, dtype=np.float64)
    x = np.cos(np.pi * (i - 0.25) / (n + 0.5))  # north-to-south
    for _ in range(100):
        p0 = np.ones_like(x)
        p1 = x.copy()
        for k in range(2, n + 1):
            p0, p1 = p1, ((2 * k - 1) * x * p1 - (k - 1) * p0) / k
        dp = n * (x * p1 - p0) / (x * x - 1.0)
        dx = p1 / dp
        x -= dx
        if float(np.max(np.abs(dx))) < 1e-15:
            break
    return np.degrees(np.arcsin(x))


def _gaussian_subset(n_half, lat_first, lat_last, nj):
    """Select the nj consecutive Gaussian latitudes of the N-grid whose
    first row matches lat_first (GRIB messages may carry a sub-area)."""
    glats = gaussian_latitudes(n_half)
    if lat_first < lat_last:  # south-to-north scanning
        glats = glats[::-1]
    i0 = int(np.argmin(np.abs(glats - lat_first)))
    if abs(glats[i0] - lat_first) > 0.05 or i0 + nj > len(glats):
        raise ValueError(
            f"first latitude {lat_first} does not sit on the N{n_half} "
            f"Gaussian grid (nearest {glats[i0]:.6f}, nj={nj})")
    return glats[i0:i0 + nj].copy()


def _reduced_to_regular(flat, pl, lon_start, ni_reg):
    """Interpolate a reduced-Gaussian field (per-row point counts ``pl``,
    rows concatenated west->east starting at ``lon_start`` with periodic
    360/pl[r] spacing) onto ``ni_reg`` regular longitudes — periodic
    linear interpolation per row, the moral equivalent of what
    eccodes/Metview do when regularizing reduced grids."""
    pl = np.asarray(pl, dtype=np.int64)
    if len(pl) * ni_reg > 200_000_000:
        raise ValueError(
            f"implausible regularized grid {len(pl)}x{ni_reg}")
    out = np.empty((len(pl), ni_reg), dtype=np.float64)
    tfrac = np.arange(ni_reg, dtype=np.float64) / ni_reg  # target, turns
    pos = 0
    for r, n in enumerate(pl):
        n = int(n)
        row = flat[pos:pos + n]
        pos += n
        f = tfrac * n  # target position in source-row units
        i0 = np.floor(f).astype(np.int64) % n
        i1 = (i0 + 1) % n
        w = f - np.floor(f)
        out[r] = row[i0] * (1.0 - w) + row[i1] * w
    lons = lon_start + 360.0 * tfrac
    return out, lons


def _decode_grib1_message(buf, off):
    """Decode one GRIB1 message at `off`; returns (record dict, next_off)."""
    assert buf[off:off + 4] == b"GRIB"
    total = int.from_bytes(buf[off + 4:off + 7], "big")
    edition = buf[off + 7]
    assert edition == 1
    pos = off + 8

    # --- PDS
    pds_len = int.from_bytes(buf[pos:pos + 3], "big")
    pds = buf[pos:pos + pds_len]
    table2 = pds[3]
    flags = pds[7]
    has_gds, has_bms = bool(flags & 0x80), bool(flags & 0x40)
    param = pds[8]
    level_type = pds[9]
    level = int.from_bytes(pds[10:12], "big")
    yy, mm, dd, hh, mi = pds[12], pds[13], pds[14], pds[15], pds[16]
    time_unit, p1, p2, tri = pds[17], pds[18], pds[19], pds[20]
    century = pds[24]
    dec_scale = _sm16(pds[26:28])
    # ECMWF local extension (centre 98, local definition 1): octet 41 is
    # the local definition number, octets 46-49 the 4-char experiment
    # version — "0001" = final ERA5, "0005" = preliminary ERA5T (the
    # dual-stream layout near-present CDS GRIB downloads carry; the
    # reference resolves it through cfgrib, era5.py:352-429)
    expver = None
    if pds[4] == 98 and pds_len >= 49:
        try:
            ev = pds[45:49].decode("ascii")
            if ev.strip() and all(c.isalnum() for c in ev.strip()):
                expver = ev
        except UnicodeDecodeError:
            pass
    year = (century - 1) * 100 + yy
    # WMO table 4 + ECMWF extensions; an UNKNOWN unit must refuse — a
    # silent hours default would mislabel valid_time and poison
    # to_dataset's shared time axis
    _G1_UNITS = {0: 1 / 60, 1: 1.0, 2: 24.0, 10: 3.0, 11: 6.0, 12: 12.0,
                 13: 0.25, 14: 0.5, 254: 1 / 3600}
    if time_unit not in _G1_UNITS:
        raise NotImplementedError(f"GRIB1 time unit {time_unit}")
    step_h = _G1_UNITS[time_unit]
    if tri == 4:  # accumulation over (P1, P2): labelled by interval end
        step = p2 * step_h
    else:
        step = p1 * step_h
    ref = np.datetime64(f"{year:04d}-{mm:02d}-{dd:02d}T{hh:02d}:{mi:02d}")
    valid_time = ref + np.timedelta64(int(round(step * 60)), "m")
    pos += pds_len

    # --- GDS
    if not has_gds:
        raise NotImplementedError("GRIB1 message without GDS")
    gds_len = int.from_bytes(buf[pos:pos + 3], "big")
    gds = buf[pos:pos + gds_len]
    nv, pvloc = gds[3], gds[4]
    drt = gds[5]
    if drt not in (0, 4):
        raise NotImplementedError(
            f"GRIB1 grid type {drt} (lat/lon and Gaussian only)")
    ni = int.from_bytes(gds[6:8], "big")
    nj = int.from_bytes(gds[8:10], "big")
    lat1 = _sm24(gds[10:13]) / 1000.0
    lon1 = _sm24(gds[13:16]) / 1000.0
    lat2 = _sm24(gds[17:20]) / 1000.0
    lon2 = _sm24(gds[20:23]) / 1000.0
    scan = gds[27]
    # i/j scan DIRECTIONS are encoded by the lat1/lat2, lon1/lon2
    # endpoints (linspace handles either ordering); but bit 0x20
    # (adjacent points in j consecutive = column-major data) breaks the
    # reshape(nj, ni) row-major assumption — refuse rather than silently
    # transpose the field
    if scan & 0x20:
        raise NotImplementedError("GRIB1 j-consecutive scanning mode")
    pl = None
    if drt == 4 and ni == 0xFFFF:  # reduced Gaussian: per-row PL list
        if pvloc in (0, 255):
            raise ValueError("reduced Gaussian GRIB1 without a PL list")
        ploff = pvloc - 1 + 4 * nv
        if ploff + 2 * nj > gds_len:
            raise ValueError("GRIB1 PL list extends past the GDS")
        pl = np.frombuffer(gds, dtype=">u2", count=nj,
                           offset=ploff).astype(np.int64)
        if pl.min() < 1:
            raise ValueError("GRIB1 PL list with empty rows")
    pos += gds_len

    # --- BMS
    bitmap = None
    if has_bms:
        bms_len = int.from_bytes(buf[pos:pos + 3], "big")
        unused = buf[pos + 3]
        table_ref = int.from_bytes(buf[pos + 4:pos + 6], "big")
        if table_ref != 0:
            raise NotImplementedError("predefined GRIB1 bitmaps")
        nbits_total = (bms_len - 6) * 8 - unused
        bitmap = _unpack_bits(buf[pos + 6:pos + bms_len], 1,
                              nbits_total).astype(bool)
        pos += bms_len

    # --- BDS
    bds_len = int.from_bytes(buf[pos:pos + 3], "big")
    bds_flags = buf[pos + 3]
    if bds_flags & 0xC0:
        raise NotImplementedError("GRIB1 spherical-harmonic/complex packing")
    if bds_flags & 0x10:
        # octet 14 carries additional flag bits (secondary bitmaps,
        # matrix values): data starts past the extended header — bit-
        # unpacking from octet 12 would silently misdecode the grid
        raise NotImplementedError("GRIB1 BDS with additional flag octets")
    unused_bits = bds_flags & 0x0F
    bin_scale = _sm16(buf[pos + 4:pos + 6])
    ref_value = _ibm32_decode(buf[pos + 6:pos + 10])
    nbits = buf[pos + 10]
    data_bytes = buf[pos + 11:pos + bds_len]
    ntotal = int(pl.sum()) if pl is not None else ni * nj
    if ntotal > 100_000_000:
        raise ValueError(f"implausible GRIB1 grid size {ntotal}")
    npoints = ntotal if bitmap is None else int(bitmap[:ntotal].sum())
    if nbits:
        x = _unpack_bits(data_bytes, nbits, npoints)
        vals = ref_value + x.astype(np.float64) * 2.0 ** bin_scale
    else:
        vals = np.full(npoints, ref_value)
    vals = vals * 10.0 ** (-dec_scale)
    if bitmap is not None:
        full = np.full(ntotal, np.nan)
        full[bitmap[:ntotal]] = vals
        vals = full
    # scanning mode bit 2 (0x40): +j direction (south->north)
    if pl is not None:  # reduced Gaussian -> regularize per row
        n_half = int.from_bytes(gds[25:27], "big")
        lats = _gaussian_subset(n_half, lat1, lat2, nj)
        grid, lons = _reduced_to_regular(vals, pl, lon1, int(pl.max()))
    elif drt == 4:  # regular Gaussian: exact latitudes, uniform lons
        n_half = int.from_bytes(gds[25:27], "big")
        lats = _gaussian_subset(n_half, lat1, lat2, nj)
        lons = np.linspace(lon1, lon2, ni)
        grid = vals.reshape(nj, ni)
    else:
        lats = np.linspace(lat1, lat2, nj)
        lons = np.linspace(lon1, lon2, ni)
        grid = vals.reshape(nj, ni)
    pos += bds_len
    assert buf[off + total - 4:off + total] == b"7777", "missing GRIB1 end"

    short = GRIB1_PARAMS.get((table2, param), f"p{table2}.{param}")
    return {
        "shortName": short, "values": grid, "lats": lats, "lons": lons,
        "valid_time": valid_time, "level_type": level_type, "level": level,
        "edition": 1, "param": (table2, param), "expver": expver,
    }, off + total


def encode_grib1(records):
    """Encode records (dicts with shortName/values/lats/lons/valid_time,
    optional nbits/dec_scale) into a GRIB1 byte stream.  Used for test
    fixtures and offline archiving.

    Gaussian grids: pass ``gauss_n`` (the N of the N-grid) for grid type
    4; with ``pl`` (per-row point counts) the record is reduced Gaussian —
    ``values`` is then the flat 1-D row-concatenated array and ``lats``
    the per-row latitudes."""
    out = []
    for rec in records:
        vals = np.asarray(rec["values"], dtype=np.float64)
        lats = np.asarray(rec["lats"], dtype=float)
        lons = np.asarray(rec["lons"], dtype=float)
        pl = rec.get("pl")
        if pl is not None:
            pl = np.asarray(pl, dtype=np.int64)
            nj, ni = len(pl), 0xFFFF
            assert vals.ndim == 1 and vals.size == int(pl.sum())
        else:
            nj, ni = vals.shape
        t = np.datetime64(rec["valid_time"], "m").astype("datetime64[m]")
        tt = t.astype(object)
        table2, param = GRIB1_PARAMS_INV.get(
            rec["shortName"], rec.get("param", (128, 255)))
        nbits = int(rec.get("nbits", 16))
        dec_scale = int(rec.get("dec_scale", 0))

        mask = np.isfinite(vals)
        has_bms = not mask.all()
        flat = vals.ravel()[mask.ravel()] * 10.0 ** dec_scale
        vmin = float(flat.min()) if flat.size else 0.0
        vmax = float(flat.max()) if flat.size else 0.0
        # choose binary scale so the range fits nbits
        if flat.size and vmax > vmin and nbits:
            e = int(np.ceil(np.log2((vmax - vmin) / (2**nbits - 1))))
        else:
            e = 0
        ref = vmin
        ref_enc = _ibm32_encode(ref)
        ref_dec = _ibm32_decode(ref_enc)  # quantize through IBM float
        x = np.round((flat - ref_dec) / 2.0 ** e).astype(np.int64)
        x = np.clip(x, 0, 2**nbits - 1) if nbits else x

        century, yy = divmod(tt.year - 1, 100)
        pds = bytearray(28)
        pds[0:3] = (28).to_bytes(3, "big")
        pds[3] = table2
        pds[4] = 98  # ECMWF
        pds[5] = 0
        pds[6] = 255
        pds[7] = 0x80 | (0x40 if has_bms else 0)
        pds[8] = param
        pds[9] = 1  # surface
        pds[10:12] = (0).to_bytes(2, "big")
        pds[12], pds[13], pds[14] = yy + 1, tt.month, tt.day
        pds[15], pds[16] = tt.hour, tt.minute
        pds[17], pds[18], pds[19], pds[20] = 1, 0, 0, 0
        pds[21:23] = (0).to_bytes(2, "big")
        pds[23] = 0
        pds[24] = century + 1
        pds[25] = 0
        pds[26:28] = _sm16_encode(dec_scale)
        if rec.get("expver") is not None:
            # ECMWF local definition 1 (octets 41-52): local def number,
            # MARS class/type/stream, 4-char expver
            pds.extend(bytes(12))            # octets 29-40 reserved
            pds.append(1)                    # octet 41: local definition 1
            pds.append(23)                   # octet 42: MARS class 'ea'
            pds.append(2)                    # octet 43: MARS type 'an'
            pds.extend((1025).to_bytes(2, "big"))  # octets 44-45: stream
            # MARS expver is right-justified zero-padded ('1' -> '0001')
            ev = str(rec["expver"]).encode("ascii")[:4].rjust(4, b"0")
            pds.extend(ev)                   # octets 46-49: expver
            pds.extend(bytes(3))             # octets 50-52 padding
            pds[0:3] = (len(pds)).to_bytes(3, "big")

        gauss_n = rec.get("gauss_n")
        gds = bytearray(32)
        gds[0:3] = (32).to_bytes(3, "big")
        gds[3] = 0
        gds[4] = 255
        gds[5] = 4 if gauss_n else 0  # Gaussian / lat-lon
        gds[6:8] = struct.pack(">H", ni)
        gds[8:10] = struct.pack(">H", nj)
        gds[10:13] = _sm24_encode(int(round(lats[0] * 1000)))
        gds[13:16] = _sm24_encode(int(round(lons[0] * 1000)))
        gds[16] = 0x80  # resolution/direction increments given
        gds[17:20] = _sm24_encode(int(round(lats[-1] * 1000)))
        gds[20:23] = _sm24_encode(int(round(lons[-1] * 1000)))
        di = abs(lons[1] - lons[0]) if (pl is None and ni > 1) else 0
        gds[23:25] = struct.pack(">H", int(round(di * 1000)))
        if gauss_n:
            gds[25:27] = struct.pack(">H", int(gauss_n))
        else:
            dj = abs(lats[1] - lats[0]) if nj > 1 else 0
            gds[25:27] = struct.pack(">H", int(round(dj * 1000)))
        gds[27] = 0x40 if (nj > 1 and lats[1] > lats[0]) else 0
        # octets 29-32 reserved (zeros)
        if pl is not None:
            gds[4] = 33  # PL list at octet 33 (no vertical coords)
            gds.extend(b"".join(struct.pack(">H", int(p)) for p in pl))
            gds[0:3] = len(gds).to_bytes(3, "big")

        bms = b""
        if has_bms:
            bits = _pack_bits(mask.ravel().astype(np.int64), 1)
            unused = (8 - (mask.size % 8)) % 8
            bms_len = 6 + len(bits)
            if bms_len % 2:
                bits += b"\x00"
                bms_len += 1
                unused += 8
            bms = (bms_len.to_bytes(3, "big") + bytes([unused])
                   + b"\x00\x00" + bits)

        packed = _pack_bits(x, nbits)
        bds_len = 11 + len(packed)
        pad = bds_len % 2
        bds_len += pad
        unused_bits = (len(packed) * 8 - nbits * len(x)) + 8 * pad
        bds = ((bds_len).to_bytes(3, "big") + bytes([unused_bits & 0x0F])
               + _sm16_encode(e) + ref_enc + bytes([nbits]) + packed
               + b"\x00" * pad)

        body = bytes(pds) + bytes(gds) + bms + bds + b"7777"
        total = 8 + len(body)
        out.append(b"GRIB" + total.to_bytes(3, "big") + bytes([1]) + body)
    return b"".join(out)


# ---------------------------------------------------------------------------
# GRIB2
# ---------------------------------------------------------------------------
# (discipline, category, number, levelType, levelValue) -> shortName
GRIB2_PARAMS = {
    (0, 2, 2, 103, 10): "u10", (0, 2, 3, 103, 10): "v10",
    (0, 2, 2, 103, 100): "u100", (0, 2, 3, 103, 100): "v100",
    (0, 0, 0, 103, 2): "t2m", (0, 0, 6, 103, 2): "d2m",
    (0, 4, 9, 1, 0): "ssr", (0, 4, 7, 1, 0): "ssrd",
    (0, 4, 13, 1, 0): "fdir", (0, 4, 1, 8, 0): "tisr",
    (2, 0, 5, 1, 0): "ro", (0, 3, 4, 1, 0): "z",
    (2, 0, 1, 1, 0): "fsr", (2, 3, 18, 106, 0): "stl4",
}
GRIB2_PARAMS_INV = {v: k for k, v in GRIB2_PARAMS.items()}
# level-agnostic fallback for non-height level types: real eccodes files
# encode surface/soil levels with varying scale/value conventions (incl.
# the all-ones "missing" encoding), while height-above-ground (103)
# levels are meaningful (u10 vs u100)
GRIB2_PARAMS_NOLEVEL = {k[:4]: v for k, v in GRIB2_PARAMS.items()
                        if k[3] != 103}


def _decode_grib2_message(buf, off):
    assert buf[off:off + 4] == b"GRIB"
    discipline = buf[off + 6]
    edition = buf[off + 7]
    assert edition == 2
    total = int.from_bytes(buf[off + 8:off + 16], "big")
    pos = off + 16
    end = off + total

    meta = {"discipline": discipline}
    records = []
    while pos < end - 4:
        if buf[pos:pos + 4] == b"7777":
            break
        sec_len = int.from_bytes(buf[pos:pos + 4], "big")
        sec_num = buf[pos + 4]
        if sec_len < 5 or pos + sec_len > end:
            raise ValueError(
                f"corrupt GRIB2 section {sec_num} length {sec_len}")
        body = pos + 5
        if sec_num == 1:
            year = int.from_bytes(buf[body + 7:body + 9], "big")
            mo, dy, hr, mi = buf[body + 9], buf[body + 10], buf[body + 11], \
                buf[body + 12]
            meta["ref_time"] = np.datetime64(
                f"{year:04d}-{mo:02d}-{dy:02d}T{hr:02d}:{mi:02d}")
        elif sec_num == 3:
            tmpl = int.from_bytes(buf[body + 7:body + 9], "big")
            if tmpl not in (0, 40):
                raise NotImplementedError(f"GRIB2 grid template {tmpl}")
            losize = buf[body + 5]  # octets per optional-list entry
            g = body + 9
            ni = int.from_bytes(buf[g + 16:g + 20], "big")
            nj = int.from_bytes(buf[g + 20:g + 24], "big")
            if nj > 100_000 or (ni != 0xFFFFFFFF and ni > 100_000) \
                    or (ni != 0xFFFFFFFF and ni * nj > 100_000_000):
                raise ValueError(f"implausible GRIB2 grid {ni}x{nj}")

            def s32(o):
                v = int.from_bytes(buf[g + o:g + o + 4], "big")
                return -(v & 0x7FFFFFFF) if v & 0x80000000 else v

            lat1 = s32(32) / 1e6
            lon1 = s32(36) / 1e6
            lat2 = s32(41) / 1e6
            lon2 = s32(45) / 1e6
            scan = buf[g + 57]
            if scan & 0x20:  # column-major data order (see GRIB1 note)
                raise NotImplementedError(
                    "GRIB2 j-consecutive scanning mode")
            meta.pop("pl", None)
            if tmpl == 40:  # (reduced) Gaussian, template 3.40
                n_half = int.from_bytes(buf[g + 53:g + 57], "big")
                lats = _gaussian_subset(n_half, lat1, lat2, nj)
                if ni == 0xFFFFFFFF:  # reduced: per-row list ends sec 3
                    if losize == 0:
                        raise ValueError(
                            "reduced Gaussian GRIB2 without a PL list")
                    lo = pos + sec_len - nj * losize
                    if lo < g + 58:
                        raise ValueError("GRIB2 PL list overlaps template")
                    pl = np.array(
                        [int.from_bytes(buf[lo + i * losize:
                                            lo + (i + 1) * losize], "big")
                         for i in range(nj)], dtype=np.int64)
                    if pl.min() < 1:
                        raise ValueError("GRIB2 PL list with empty rows")
                    if pl.max() > 100_000 or pl.sum() > 100_000_000:
                        raise ValueError("implausible GRIB2 PL list")
                    ni = int(pl.max())
                    meta.update(ni=ni, nj=nj, pl=pl, lon1=lon1, lats=lats,
                                lons=lon1 + 360.0 * np.arange(ni) / ni)
                else:
                    meta.update(ni=ni, nj=nj, lats=lats,
                                lons=np.linspace(lon1, lon2, ni))
            else:
                meta.update(ni=ni, nj=nj,
                            lats=np.linspace(lat1, lat2, nj),
                            lons=np.linspace(lon1, lon2, ni))
        elif sec_num == 4:
            tmpl = int.from_bytes(buf[body + 2:body + 4], "big")
            # template 4.0 octets (1-based in section): 10 category,
            # 11 number, 18 time unit, 19-22 forecast time, 23 first
            # surface type, 24 scale factor, 25-28 scaled value
            p = body + 4
            cat, num = buf[p], buf[p + 1]
            unit = buf[p + 8]
            fcst = int.from_bytes(buf[p + 9:p + 13], "big")
            lev_type = buf[p + 13]
            lev_scale = buf[p + 14]
            lev_val = int.from_bytes(buf[p + 15:p + 19], "big")
            # WMO table 4.4 (13 = seconds); unknown units refuse like GRIB1
            _G2_UNITS = {0: 1 / 60, 1: 1.0, 2: 24.0, 10: 3.0, 11: 6.0,
                         12: 12.0, 13: 1 / 3600}
            if unit not in _G2_UNITS:
                raise NotImplementedError(f"GRIB2 time unit {unit}")
            step_h = _G2_UNITS[unit]
            if lev_scale == 255 or lev_val == 0xFFFFFFFF:
                level = 0.0  # "missing" encoding (eccodes surface fields)
            elif lev_scale < 120:
                level = lev_val / 10 ** lev_scale
            else:
                level = lev_val
            meta.update(category=cat, number=num,
                        level_type=lev_type, level=level,
                        step=fcst * step_h, pd_template=tmpl)
            meta.pop("interval_end", None)
            # templates that extend 4.0 with octets APPENDED after the
            # shared prefix parsed above: 4.1/4.2 (ensemble, +3/+3
            # octets), and the statistical-interval products 4.8 (+0)
            # and 4.11 (ensemble +3) whose trailing octets carry the END
            # of the interval — the label ERA5 conventions use
            # (reference era5.py:174-188).  Anything else has a
            # different octet layout entirely; decoding the "prefix"
            # would produce garbage step/level and a bogus valid_time
            # that poisons to_dataset's shared time axis, so refuse.
            _STAT_OFFSET = {8: 29, 11: 32}  # ens. templates shift by 3
            if tmpl in _STAT_OFFSET:
                o = body + _STAT_OFFSET[tmpl]
                yr = int.from_bytes(buf[o:o + 2], "big")
                mo, dy = buf[o + 2], buf[o + 3]
                hr, mi = buf[o + 4], buf[o + 5]
                meta["interval_end"] = np.datetime64(
                    f"{yr:04d}-{mo:02d}-{dy:02d}T{hr:02d}:{mi:02d}")
            elif tmpl in (1, 2):
                logger.warning(
                    "GRIB2 ensemble product template 4.%d: decoding the "
                    "shared 4.0 octet prefix (no perturbation metadata)",
                    tmpl)
            elif tmpl != 0:
                raise NotImplementedError(f"GRIB2 product template {tmpl}")
        elif sec_num == 5:
            ndata = int.from_bytes(buf[body:body + 4], "big")
            tmpl = int.from_bytes(buf[body + 4:body + 6], "big")
            d = body + 6
            if tmpl == 4:  # IEEE floating point (grid_ieee), no packing
                meta.update(ndata=ndata, drs_template=tmpl,
                            ieee_precision=buf[d])
                pos += sec_len
                continue
            ref = struct.unpack(">f", buf[d:d + 4])[0]
            e = _sm16(buf[d + 4:d + 6])
            dec = _sm16(buf[d + 6:d + 8])
            nbits = buf[d + 8]
            meta.update(ndata=ndata, drs_template=tmpl, ref=ref,
                        bin_scale=e, dec_scale=dec, nbits=nbits)
            if tmpl == 42:  # CCSDS/AEC (grib_ccsds, libaec)
                meta["ccsds_flags"] = buf[d + 9]
                meta["ccsds_block"] = buf[d + 10]
                meta["ccsds_rsi"] = int.from_bytes(buf[d + 11:d + 13], "big")
            elif tmpl == 41:  # PNG packing: no extra descriptors
                pass
            elif tmpl == 40:  # JPEG2000 (grib_jpeg): octet 22 is the
                # compression type (0 lossless / 1 lossy), 23 the target
                # ratio; the codestream itself carries the real geometry
                meta["jp2_lossy"] = buf[d + 10] == 1
            elif tmpl in (2, 3):
                # complex packing descriptors (templates 5.2/5.3)
                meta["group_split"] = buf[d + 10]
                meta["missing_mgmt"] = buf[d + 11]
                meta["ngroups"] = int.from_bytes(buf[d + 20:d + 24], "big")
                meta["group_width_ref"] = buf[d + 24]
                meta["group_width_bits"] = buf[d + 25]
                meta["group_len_ref"] = int.from_bytes(buf[d + 26:d + 30], "big")
                meta["group_len_inc"] = buf[d + 30]
                meta["group_len_last"] = int.from_bytes(buf[d + 31:d + 35], "big")
                meta["group_len_bits"] = buf[d + 35]
                if tmpl == 3:
                    meta["spatial_order"] = buf[d + 36]
                    meta["spatial_desc_bytes"] = buf[d + 37]
            elif tmpl != 0:
                raise NotImplementedError(f"GRIB2 DRS template {tmpl}")
        elif sec_num == 6:
            ind = buf[body]
            if ind == 0:
                nbits_total = int(meta["pl"].sum()) \
                    if meta.get("pl") is not None else meta["ni"] * meta["nj"]
                meta["bitmap"] = _unpack_bits(
                    buf[body + 1:pos + sec_len], 1, nbits_total).astype(bool)
            elif ind == 255:
                # "no bitmap applies" must CLEAR any bitmap from a
                # previous (sec4..sec7) set in this message; 254 means
                # the previously-defined one applies (keep it)
                meta.pop("bitmap", None)
            elif ind != 254:
                raise NotImplementedError("predefined GRIB2 bitmaps")
        elif sec_num == 7:
            # build the record NOW: a message may legally carry several
            # (sec4,sec5,sec6,sec7) sets, each with its own product
            # metadata — labelling all grids with the final meta would
            # silently mislabel every field but the last
            vals = _decode_grib2_data(buf[body:pos + sec_len], meta)
            key = (discipline, meta["category"], meta["number"],
                   meta["level_type"], int(meta["level"]))
            short = GRIB2_PARAMS.get(
                key, GRIB2_PARAMS_NOLEVEL.get(key[:4], f"p{key}"))
            if meta.get("pl") is not None:
                grid, _ = _reduced_to_regular(vals, meta["pl"],
                                              meta["lon1"], meta["ni"])
            else:
                grid = vals.reshape(meta["nj"], meta["ni"])
            records.append({
                "shortName": short,
                "values": grid,
                "lats": meta["lats"], "lons": meta["lons"],
                "valid_time": meta.get(
                    "interval_end",
                    meta["ref_time"]
                    + np.timedelta64(int(meta.get("step", 0) * 60), "m")),
                "level_type": meta["level_type"], "level": meta["level"],
                "edition": 2, "param": key,
            })
        pos += sec_len

    return records, off + total


def _decode_grib2_data(data, meta):
    n = meta["ndata"]
    tmpl = meta["drs_template"]
    if tmpl == 4:  # IEEE floats, raw (template 5.4 / grid_ieee)
        prec = meta.get("ieee_precision", 1)
        dt = {1: ">f4", 2: ">f8"}.get(prec)
        if dt is None:
            raise NotImplementedError(f"IEEE precision code {prec}")
        if n < 0 or n > 100_000_000 or n * np.dtype(dt).itemsize > len(data):
            raise ValueError("GRIB2 IEEE data section too short")
        vals = np.frombuffer(data, dtype=dt, count=n).astype(np.float64)
    else:
        nbits = meta["nbits"]
        if tmpl == 0:
            x = _unpack_bits(data, nbits, n).astype(np.float64)
        elif tmpl == 41:  # PNG packing (template 5.41, eccodes grib_png)
            from atlite_tpu_torch.io import png as _png

            img = _png.decode(data)
            h, w, ch = img.shape
            if img.dtype == np.uint16:  # 16-bit grayscale
                x = img[:, :, 0].astype(np.float64)
            else:  # channels carry the sample's bytes big-endian
                x = np.zeros((h, w), dtype=np.float64)
                for c in range(ch):
                    x = x * 256.0 + img[:, :, c].astype(np.float64)
            x = x.reshape(-1)
            if x.size < n:
                raise ValueError("PNG-packed field decoded short")
            x = x[:n]
        elif tmpl == 40:  # JPEG2000 packing (template 5.40, grib_jpeg)
            from atlite_tpu_torch.io import jp2 as _jp2

            if nbits == 0:  # constant field: value = ref everywhere
                x = np.zeros(n)
            else:
                img = _jp2.decode(bytes(data))
                x = img.astype(np.float64).reshape(-1)
                if x.size < n:
                    raise ValueError("JPEG2000-packed field decoded short")
                x = x[:n]
        elif tmpl == 42:  # CCSDS lossless (template 5.42)
            if n < 0 or n > 100_000_000:
                raise ValueError(f"implausible CCSDS sample count {n}")
            if nbits == 0:
                x = np.zeros(n)
            else:
                from atlite_tpu_torch.io import aec as _aec

                aflags = meta["ccsds_flags"]
                raw = _aec.decode(data, n, nbits, meta["ccsds_block"],
                                  meta["ccsds_rsi"], aflags)
                nbytes = _aec.sample_nbytes(nbits, aflags)
                if len(raw) < n * nbytes:
                    raise ValueError("CCSDS stream decoded short")
                bo = ">" if (aflags & _aec.AEC_DATA_MSB) else "<"
                if nbytes == 3:  # no 3-byte dtype: widen manually
                    b = np.frombuffer(raw, dtype=np.uint8,
                                      count=3 * n).reshape(n, 3)
                    o = (0, 1, 2) if bo == ">" else (2, 1, 0)
                    x = (b[:, o[0]].astype(np.float64) * 65536.0
                         + b[:, o[1]] * 256.0 + b[:, o[2]])
                else:
                    x = np.frombuffer(raw, dtype=f"{bo}u{nbytes}",
                                      count=n).astype(np.float64)
        else:
            x = _decode_complex(data, meta).astype(np.float64)
        vals = (meta["ref"] + x * 2.0 ** meta["bin_scale"]) \
            * 10.0 ** (-meta["dec_scale"])
    bitmap = meta.get("bitmap")
    if bitmap is not None:
        full = np.full(bitmap.size, np.nan)
        full[bitmap] = vals
        vals = full
    return vals


def _decode_complex(data, meta):
    """Complex packing (5.2) and complex + spatial differencing (5.3)."""
    if meta.get("missing_mgmt", 0) != 0:
        # missing points are encoded IN-STREAM (all-ones references);
        # decoding them as data would emit huge finite values silently
        raise NotImplementedError(
            "GRIB2 complex packing with missing-value management "
            f"{meta['missing_mgmt']}")
    n = meta["ndata"]
    pos_bits = 0
    order = 0
    if meta["drs_template"] == 3:
        order = meta["spatial_order"]
        nb = meta["spatial_desc_bytes"]
        vals0 = []
        for i in range(order):
            v = int.from_bytes(data[(i) * nb:(i + 1) * nb], "big")
            sign_bit = 1 << (nb * 8 - 1)
            vals0.append(-(v & (sign_bit - 1)) if v & sign_bit else v)
        gmin_raw = int.from_bytes(data[order * nb:(order + 1) * nb], "big")
        sign_bit = 1 << (nb * 8 - 1)
        gmin = -(gmin_raw & (sign_bit - 1)) if gmin_raw & sign_bit else gmin_raw
        pos_bits = (order + 1) * nb * 8

    ng = meta["ngroups"]
    refs = _unpack_bits(data, meta["nbits"], ng, pos_bits)
    pos_bits += meta["nbits"] * ng
    pos_bits = (pos_bits + 7) & ~7
    widths = meta["group_width_ref"] + _unpack_bits(
        data, meta["group_width_bits"], ng, pos_bits)
    pos_bits += meta["group_width_bits"] * ng
    pos_bits = (pos_bits + 7) & ~7
    lengths = meta["group_len_ref"] + meta["group_len_inc"] * _unpack_bits(
        data, meta["group_len_bits"], ng, pos_bits)
    pos_bits += meta["group_len_bits"] * ng
    pos_bits = (pos_bits + 7) & ~7
    lengths = np.asarray(lengths)
    if ng:
        lengths[-1] = meta["group_len_last"]

    out = np.empty(n, dtype=np.int64)
    idx = 0
    for gref, gw, gl in zip(refs, widths, lengths):
        vals = _unpack_bits(data, int(gw), int(gl), pos_bits) if gw \
            else np.zeros(int(gl), dtype=np.int64)
        out[idx:idx + int(gl)] = gref + vals
        pos_bits += int(gw) * int(gl)
        idx += int(gl)
    assert idx == n, f"complex packing: {idx} != {n} points"

    if meta["drs_template"] == 3:
        # undo spatial differencing (first or second order)
        out = out + gmin
        if order >= 1:
            out[0] = vals0[0]
        if order == 2:
            out[1] = vals0[1]
            for i in range(2, n):
                out[i] = out[i] + 2 * out[i - 1] - out[i - 2]
        elif order == 1:
            for i in range(1, n):
                out[i] = out[i] + out[i - 1]
    return out


def encode_grib2(records):
    """Encode records as GRIB2 with simple packing (templates 3.0/4.0/5.0).

    Pass ``gauss_n`` for a Gaussian grid (template 3.40); with ``pl``
    (per-row point counts) it is reduced Gaussian and ``values`` is the
    flat row-concatenated 1-D array."""
    out = []
    for rec in records:
        vals = np.asarray(rec["values"], dtype=np.float64)
        lats = np.asarray(rec["lats"], dtype=float)
        lons = np.asarray(rec["lons"], dtype=float)
        pl = rec.get("pl")
        gauss_n = rec.get("gauss_n")
        if pl is not None:
            pl = np.asarray(pl, dtype=np.int64)
            nj, ni = len(pl), 0xFFFFFFFF
            assert vals.ndim == 1 and vals.size == int(pl.sum())
        else:
            nj, ni = vals.shape
        key = GRIB2_PARAMS_INV.get(rec["shortName"], rec.get("param"))
        discipline, cat, num, lev_type, lev = key
        nbits = int(rec.get("nbits", 16))
        t = np.datetime64(rec["valid_time"], "m").astype(object)

        mask = np.isfinite(vals)
        has_bms = not mask.all()
        flat = vals.ravel()[mask.ravel()]
        vmin = float(flat.min()) if flat.size else 0.0
        vmax = float(flat.max()) if flat.size else 0.0
        if flat.size and vmax > vmin and nbits:
            e = int(np.ceil(np.log2((vmax - vmin) / (2**nbits - 1))))
        else:
            e = 0
        ref = np.float32(vmin)
        x = np.round((flat - float(ref)) / 2.0 ** e).astype(np.int64)
        x = np.clip(x, 0, 2**nbits - 1) if nbits else x

        interval_h = rec.get("interval_hours")
        # interval products reference the START of the interval; the
        # valid_time labels its end (template 4.8 semantics)
        t_ref = (np.datetime64(rec["valid_time"], "m")
                 - np.timedelta64(int(interval_h * 60), "m")).astype(object) \
            if interval_h else t
        sec1 = (struct.pack(">IB", 21, 1) + struct.pack(">HH", 98, 0)
                + bytes([2, 1, 1])
                + struct.pack(">H", t_ref.year)
                + bytes([t_ref.month, t_ref.day, t_ref.hour, t_ref.minute,
                         0, 0, 1]))
        npts = int(pl.sum()) if pl is not None else ni * nj
        g = bytearray(72)
        struct.pack_into(">I", g, 0, 72)
        g[4] = 3
        g[5] = 0
        struct.pack_into(">I", g, 6, npts)
        g[10] = 2 if pl is not None else 0  # octets per PL entry
        g[11] = 1 if pl is not None else 0  # list = points per row
        struct.pack_into(">H", g, 12, 40 if gauss_n else 0)  # template
        body = 14
        g[body + 16:body + 20] = struct.pack(">I", ni)
        g[body + 20:body + 24] = struct.pack(">I", nj)

        def s32e(v):
            return struct.pack(">I", (0x80000000 | -v) if v < 0 else v)

        g[body + 32:body + 36] = s32e(int(round(lats[0] * 1e6)))
        g[body + 36:body + 40] = s32e(int(round(lons[0] * 1e6)))
        g[body + 40] = 0x30
        g[body + 41:body + 45] = s32e(int(round(lats[-1] * 1e6)))
        g[body + 45:body + 49] = s32e(int(round(lons[-1] * 1e6)))
        di = abs(lons[1] - lons[0]) if (pl is None and ni > 1) else 0
        g[body + 49:body + 53] = struct.pack(">I", int(round(di * 1e6)))
        if gauss_n:
            g[body + 53:body + 57] = struct.pack(">I", int(gauss_n))
        else:
            dj = abs(lats[1] - lats[0]) if nj > 1 else 0
            g[body + 53:body + 57] = struct.pack(">I", int(round(dj * 1e6)))
        g[body + 57] = 0x40 if (nj > 1 and lats[1] > lats[0]) else 0
        if pl is not None:
            g.extend(b"".join(struct.pack(">H", int(p)) for p in pl))
            struct.pack_into(">I", g, 0, len(g))

        s4 = bytearray(58 if interval_h else 34)
        struct.pack_into(">I", s4, 0, len(s4))
        s4[4] = 4
        struct.pack_into(">H", s4, 5, 0)
        struct.pack_into(">H", s4, 7, 8 if interval_h else 0)  # template
        s4[9], s4[10] = cat, num
        s4[11] = 0            # generating process: analysis
        s4[12], s4[13] = 255, 255
        s4[17] = 1            # time unit: hours
        struct.pack_into(">I", s4, 18, 0)   # forecast time 0
        s4[22] = lev_type
        s4[23] = 0
        struct.pack_into(">I", s4, 24, int(lev))
        s4[28] = 255          # second fixed surface: missing
        s4[29] = 0xFF
        s4[30:34] = b"\xff\xff\xff\xff"
        if interval_h:
            # template 4.8 trailer: end-of-interval timestamp + one
            # accumulation time range of interval_h hours
            struct.pack_into(">H", s4, 34, t.year)
            s4[36], s4[37] = t.month, t.day
            s4[38], s4[39], s4[40] = t.hour, t.minute, 0
            s4[41] = 1                        # one time range
            struct.pack_into(">I", s4, 42, 0)  # no missing values
            s4[46] = 1                        # statistical process: accum
            s4[47] = 2                        # time-increment type
            s4[48] = 1                        # range unit: hours
            struct.pack_into(">I", s4, 49, int(interval_h))
            s4[53] = 1
            struct.pack_into(">I", s4, 54, 0)

        if rec.get("ieee"):  # template 5.4: raw IEEE f32, no packing
            s5 = (struct.pack(">IB", 12, 5) + struct.pack(">I", len(flat))
                  + struct.pack(">H", 4) + bytes([1]))
            payload = flat.astype(">f4").tobytes()
        elif rec.get("png"):  # template 5.41 (grib_png)
            from atlite_tpu_torch.io import png as _png

            n_present = len(x)  # ndata: pre-padding count
            if n_present == nj * ni and pl is None:
                hh, ww = nj, ni
            else:  # bitmapped/reduced: near-square image, zero-padded
                # (a 1xN scanline would trip the decoder's dimension
                # guards for realistically-sized fields)
                ww = min(n_present, 16384)
                hh = -(-n_present // max(ww, 1))
                x = np.pad(x, (0, hh * ww - n_present))
            if nbits <= 8:
                img = x.astype(np.uint8).reshape(hh, ww, 1)
            elif nbits <= 16:
                img = x.astype(np.uint16).reshape(hh, ww, 1)
            elif nbits <= 24:
                img = np.stack([(x >> 16) & 0xFF, (x >> 8) & 0xFF,
                                x & 0xFF], axis=-1) \
                    .astype(np.uint8).reshape(hh, ww, 3)
            else:
                img = np.stack([(x >> 24) & 0xFF, (x >> 16) & 0xFF,
                                (x >> 8) & 0xFF, x & 0xFF], axis=-1) \
                    .astype(np.uint8).reshape(hh, ww, 4)
            payload = _png.encode(img)
            s5 = (struct.pack(">IB", 21, 5) + struct.pack(">I", n_present)
                  + struct.pack(">H", 41) + struct.pack(">f", float(ref))
                  + _sm16_encode(e) + _sm16_encode(0) + bytes([nbits, 0]))
        elif rec.get("jp2"):  # template 5.40 (grib_jpeg, J2K codestream)
            # fixture ENCODER only, via Pillow's openjpeg integration —
            # lazily imported so Pillow stays off the library import
            # path; the production decode path is the ctypes libopenjp2
            # binding (io/jp2.py), and tests pin the two against each
            # other.
            import os as _os
            import tempfile as _tmp

            from PIL import Image as _Image

            n_present = len(x)
            if n_present == nj * ni and pl is None:
                hh, ww = nj, ni
            else:  # bitmapped/reduced: near-square, zero-padded image
                ww = min(n_present, 16384)
                hh = -(-n_present // max(ww, 1))
                x = np.pad(x, (0, hh * ww - n_present))
            if nbits > 16:
                raise ValueError("jp2 fixture encoder supports nbits <= 16")
            fd, pth = _tmp.mkstemp(suffix=".j2k")
            _os.close(fd)
            try:
                _Image.fromarray(x.astype(np.uint16).reshape(hh, ww)).save(
                    pth, format="JPEG2000", irreversible=False)
                with open(pth, "rb") as fh:
                    payload = fh.read()
            finally:
                _os.unlink(pth)
            s5 = (struct.pack(">IB", 23, 5) + struct.pack(">I", n_present)
                  + struct.pack(">H", 40) + struct.pack(">f", float(ref))
                  + _sm16_encode(e) + _sm16_encode(0)
                  + bytes([nbits, 0, 0, 255]))  # lossless, ratio n/a
        elif rec.get("ccsds"):  # template 5.42 via libaec (grib_ccsds)
            from atlite_tpu_torch.io import aec as _aec

            block, rsi = 32, 128
            aflags = _aec.AEC_DATA_MSB | _aec.AEC_DATA_PREPROCESS
            nbytes = 4 if nbits > 16 else (2 if nbits > 8 else 1)
            samples = x.astype(f">u{nbytes}").tobytes()
            payload = _aec.encode(samples, nbits, block, rsi, aflags)
            s5 = (struct.pack(">IB", 24, 5) + struct.pack(">I", len(x))
                  + struct.pack(">H", 42) + struct.pack(">f", float(ref))
                  + _sm16_encode(e) + _sm16_encode(0) + bytes([nbits])
                  + bytes([aflags, block]) + struct.pack(">H", rsi))
        else:
            s5 = (struct.pack(">IB", 21, 5)
                  + struct.pack(">I", len(x))
                  + struct.pack(">H", 0)
                  + struct.pack(">f", float(ref))
                  + _sm16_encode(e) + _sm16_encode(0) + bytes([nbits, 0]))
            payload = _pack_bits(x, nbits)
        if has_bms:
            bits = _pack_bits(mask.ravel().astype(np.int64), 1)
            s6 = struct.pack(">IB", 6 + len(bits), 6) + bytes([0]) + bits
        else:
            s6 = struct.pack(">IB", 6, 6) + bytes([255])
        s7 = struct.pack(">IB", 5 + len(payload), 7) + payload

        body_all = sec1 + bytes(g) + bytes(s4) + s5 + s6 + s7 + b"7777"
        total = 16 + len(body_all)
        out.append(b"GRIB" + b"\x00\x00" + bytes([discipline, 2])
                   + struct.pack(">Q", total) + body_all)
    return b"".join(out)


# ---------------------------------------------------------------------------
# front door
# ---------------------------------------------------------------------------
def read(path_or_bytes):
    """Decode all GRIB messages (edition 1 or 2) in a file/bytes.

    Returns a list of record dicts with keys shortName, values (nj, ni),
    lats, lons, valid_time, level_type, level, edition."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    records = []
    pos = 0
    while True:
        pos = buf.find(b"GRIB", pos)
        if pos < 0:
            break
        try:
            edition = buf[pos + 7]
            if edition == 1:
                rec, next_pos = _decode_grib1_message(buf, pos)
                records.append(rec)
            elif edition == 2:
                recs, next_pos = _decode_grib2_message(buf, pos)
                records.extend(recs)
            else:
                raise NotImplementedError(f"GRIB edition {edition}")
        except (NotImplementedError, ValueError):
            raise
        except (IndexError, KeyError, TypeError, AssertionError, OverflowError,
                MemoryError, UnicodeDecodeError, struct.error) as exc:
            # the codec is the framework's outermost trust boundary:
            # malformed bytes must fail as a clean ValueError, never as a
            # stray internal exception, hang, or silent misdecode
            raise ValueError(
                f"corrupt GRIB message at byte {pos}: {exc!r}") from exc
        if next_pos <= pos:  # a corrupt total-length field must not loop
            raise ValueError(f"corrupt GRIB message length at byte {pos}")
        pos = next_pos
    if not records:
        raise ValueError("no GRIB messages found in input")
    return records


def to_dataset(records):
    """Stack records into {shortName: (('time','y','x'), array)} plus
    coords, sorted by valid_time; latitudes normalized ascending."""
    if not records:
        raise ValueError("to_dataset: no GRIB records")
    by_var = {}
    for rec in records:
        by_var.setdefault(rec["shortName"], []).append(rec)
    first = records[0]
    lats, lons = first["lats"], first["lons"]
    for rec in records[1:]:
        # same-shaped records on a DIFFERENT grid would be silently
        # mislabeled onto the first record's coordinates
        if (rec["lats"].shape != lats.shape
                or rec["lons"].shape != lons.shape
                or not np.allclose(rec["lats"], lats, atol=1e-6)
                or not np.allclose(rec["lons"], lons, atol=1e-6)):
            raise ValueError(
                "GRIB records span different grids; decode them separately "
                f"({rec['shortName']} @ {rec['valid_time']})")
    flip = len(lats) > 1 and lats[0] > lats[-1]
    times = sorted({np.datetime64(r["valid_time"], "ns") for r in records})
    t_index = {t: i for i, t in enumerate(times)}
    data = {}
    for name, recs in by_var.items():
        arr = np.full((len(times), len(lats), len(lons)), np.nan)
        # ERA5/ERA5T dual-stream merge: where both experiment versions
        # cover a valid_time, the final ERA5 ("0001") message must win
        # over preliminary ERA5T ("0005") — stable sort applies 0001
        # last so it overwrites (reference behavior via cfgrib +
        # test_preparation_and_conversion.py:524-555)
        recs = sorted(recs, key=lambda r: r.get("expver") == "0001")
        for r in recs:
            vals = r["values"]
            if flip:
                vals = vals[::-1]
            arr[t_index[np.datetime64(r["valid_time"], "ns")]] = vals
        data[name] = (("time", "y", "x"), arr)
    y = lats[::-1].copy() if flip else lats
    coords = {"time": np.asarray(times, dtype="datetime64[ns]"),
              "y": y, "x": lons}
    return data, coords
