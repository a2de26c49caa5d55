"""Minimal GeoTIFF reader and writer — pure Python, no GDAL (a copy of
``atlite_tpu/gis/geotiff.py``).

Supports the raster flavors land-use/exclusion datasets actually ship as:
single-band baseline TIFF, striped or tiled, uncompressed / Deflate / LZW /
PackBits, little- or big-endian, integer and float sample types, with the
GeoTIFF keys needed for georeferencing (ModelPixelScale + ModelTiepoint or
ModelTransformation, and the EPSG code from GeoKeyDirectory).

atlite's counterpart: rasterio/GDAL windowed reads feeding the exclusion
pipeline (its gis.py:197-230, datasets/gebco.py:23-44).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from atlite_tpu_torch.core.grid import Affine

# TIFF tag ids
_TAGS = {
    256: "ImageWidth", 257: "ImageLength", 258: "BitsPerSample",
    259: "Compression", 262: "Photometric", 273: "StripOffsets",
    277: "SamplesPerPixel", 278: "RowsPerStrip", 279: "StripByteCounts",
    317: "Predictor", 322: "TileWidth", 323: "TileLength",
    324: "TileOffsets", 325: "TileByteCounts", 339: "SampleFormat",
    33550: "ModelPixelScale", 33922: "ModelTiepoint",
    34264: "ModelTransformation", 34735: "GeoKeyDirectory",
    42113: "GDALNoData",
}

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
               10: 8, 11: 4, 12: 8, 16: 8, 17: 8, 13: 4}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 5: "II", 8: "h", 9: "i", 11: "f",
             12: "d", 16: "Q", 17: "q", 13: "I"}


def _sample_dtype(bits, fmt, endian):
    kind = {1: "u", 2: "i", 3: "f"}.get(fmt, "u")
    return np.dtype(f"{endian}{kind}{bits // 8}")


def _lzw_decode(data: bytes, max_out=None) -> bytes:
    """TIFF-flavor LZW (MSB-first codes, EarlyChange).  ``max_out`` caps
    the output (bomb protection); the caller validates the final size."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    table = None
    code_size = 9
    prev = None
    bitbuf = 0
    nbits = 0
    pos = 0
    n = len(data)

    def reset():
        nonlocal table, code_size, prev
        table = [bytes([i]) for i in range(256)] + [b"", b""]
        code_size = 9
        prev = None

    reset()
    while True:
        while nbits < code_size:
            if pos >= n:
                return bytes(out)
            bitbuf = (bitbuf << 8) | data[pos]
            pos += 1
            nbits += 8
        code = (bitbuf >> (nbits - code_size)) & ((1 << code_size) - 1)
        nbits -= code_size
        if code == CLEAR:
            reset()
            continue
        if code == EOI:
            return bytes(out)
        if prev is None:
            entry = table[code]
            out += entry
            prev = entry
            continue
        if code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        else:
            entry = prev + prev[:1]
            table.append(entry)
        out += entry
        prev = entry
        if max_out is not None and len(out) > max_out:
            return bytes(out)
        # EarlyChange: bump code size one entry early
        if len(table) >= (1 << code_size) - 1 and code_size < 12:
            code_size += 1


def _lzw_encode(data: bytes) -> bytes:
    """TIFF-flavor LZW encoder (MSB-first codes, EarlyChange) — the
    mirror of _lzw_decode; code-size bumps track the decoder's table
    growth exactly (next_code == (1<<cs)-1)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    bitbuf = 0
    nbits = 0

    def emit(code, cs):
        nonlocal bitbuf, nbits
        bitbuf = (bitbuf << cs) | code
        nbits += cs
        while nbits >= 8:
            out.append((bitbuf >> (nbits - 8)) & 0xFF)
            nbits -= 8

    def fresh_table():
        return {bytes([i]): i for i in range(256)}

    table = fresh_table()
    next_code = 258
    cs = 9
    emit(CLEAR, cs)
    w = b""
    for ch in data:
        wc = w + bytes([ch])
        if wc in table:
            w = wc
            continue
        emit(table[w], cs)
        table[wc] = next_code
        next_code += 1
        # the decoder's table lags one code behind (it cannot grow on the
        # first code after CLEAR): it reads at cs+1 bits once ITS length
        # (= next_code - 1) reaches (1<<cs) - 1
        if next_code == (1 << cs) and cs < 12:
            cs += 1
        if next_code >= 4094:  # table nearly full: restart
            emit(CLEAR, cs)
            table = fresh_table()
            next_code = 258
            cs = 9
        w = bytes([ch])
    if w:
        emit(table[w], cs)
        # the decoder appends one more entry after receiving this final
        # code — if that lands on a width threshold it reads EOI at
        # cs+1, so the encoder must apply the same bump before EOI
        next_code += 1
        if next_code == (1 << cs) and cs < 12:
            cs += 1
    emit(EOI, cs)
    if nbits:
        out.append((bitbuf << (8 - nbits)) & 0xFF)
    return bytes(out)


def _packbits_encode(data: bytes) -> bytes:
    """PackBits with literal runs only (valid, byte-bounded output)."""
    out = bytearray()
    for i in range(0, len(data), 128):
        chunk = data[i:i + 128]
        out.append(len(chunk) - 1)
        out += chunk
    return bytes(out)


def _packbits_decode(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        h = data[i]
        i += 1
        if h < 128:
            out += data[i:i + h + 1]
            i += h + 1
        elif h > 128:
            out += data[i:i + 1] * (257 - h)
            i += 1
    return bytes(out)


def _decompress(raw, compression, decoded_size):
    # decoded_size bounds every decoder: a corrupt strip/tile must not
    # become a decompression bomb (codec trust boundary)
    if compression == 1:
        return raw
    if compression in (8, 32946):  # Deflate / legacy Deflate
        d = zlib.decompressobj()
        out = d.decompress(raw, decoded_size + 1)
        if len(out) > decoded_size:
            raise ValueError("TIFF strip inflates past its nominal size")
        return out
    if compression == 5:
        out = _lzw_decode(raw, max_out=decoded_size + 1)
        if len(out) > decoded_size:
            raise ValueError("TIFF strip inflates past its nominal size")
        return out
    if compression == 32773:
        out = _packbits_decode(raw)
        if len(out) > decoded_size + 16:
            raise ValueError("TIFF strip inflates past its nominal size")
        return out
    raise ValueError(f"unsupported TIFF compression {compression}")


def _unpredict(arr, predictor):
    if predictor == 2:  # horizontal differencing
        np.cumsum(arr, axis=-1, out=arr, dtype=arr.dtype)
    return arr


def _unpredict_fp(raw, width, bpp):
    """TIFF floating-point predictor (3): per row, undo horizontal byte
    differencing over the byte-split streams (stream order MSB-first),
    then reassemble samples as BIG-endian bytes — libtiff's layout,
    pinned against Pillow's decode in tests/test_geotiff.py."""
    stride = width * bpp
    rows = len(raw) // stride
    a = np.frombuffer(raw[:rows * stride], np.uint8).reshape(rows, stride)
    rec = (np.cumsum(a, axis=1, dtype=np.uint64) % 256).astype(np.uint8)
    streams = rec.reshape(rows, bpp, width)       # stream 0 = MSB
    return np.moveaxis(streams, 1, 2).tobytes()   # (rows, width, bpp) bytes


def read_geotiff(path) -> "Raster":
    """Read band 1 of a GeoTIFF into a gis.raster.Raster.

    Malformed input fails as a clean ValueError (codec trust boundary)."""
    try:
        return _read_geotiff(path)
    except ValueError:
        raise
    except (IndexError, KeyError, TypeError, AssertionError, OverflowError,
            MemoryError, UnicodeDecodeError, ZeroDivisionError,
            struct.error, zlib.error) as exc:
        raise ValueError(f"corrupt GeoTIFF: {exc!r}") from exc


def _read_geotiff(path) -> "Raster":
    from atlite_tpu_torch.gis.raster import Raster

    if isinstance(path, (bytes, bytearray)):
        data = bytes(path)
    else:
        data = Path(path).read_bytes()
    if data[:2] == b"II":
        endian = "<"
    elif data[:2] == b"MM":
        endian = ">"
    else:
        raise ValueError("not a TIFF file")
    magic, = struct.unpack(endian + "H", data[2:4])
    if magic == 43:  # BigTIFF: 8-byte offsets, 20-byte IFD entries
        big = True
        osize, reserved = struct.unpack(endian + "HH", data[4:8])
        if osize != 8 or reserved != 0:
            raise ValueError("malformed BigTIFF header")
        ifd_off, = struct.unpack(endian + "Q", data[8:16])
    elif magic == 42:
        big = False
        ifd_off, = struct.unpack(endian + "I", data[4:8])
    else:
        raise ValueError("not a TIFF file")

    tags = {}
    if big:
        n_entries, = struct.unpack(endian + "Q", data[ifd_off:ifd_off + 8])
        if n_entries > 65536:
            raise ValueError(f"implausible BigTIFF entry count {n_entries}")
        ent0, esz, inline = ifd_off + 8, 20, 8
    else:
        n_entries, = struct.unpack(endian + "H", data[ifd_off:ifd_off + 2])
        ent0, esz, inline = ifd_off + 2, 12, 4
    for i in range(int(n_entries)):
        e = ent0 + esz * i
        if big:
            tag, typ = struct.unpack(endian + "HH", data[e:e + 4])
            count, = struct.unpack(endian + "Q", data[e + 4:e + 12])
        else:
            tag, typ, count = struct.unpack(endian + "HHI", data[e:e + 8])
        size = _TYPE_SIZES.get(typ, 1) * count
        if size > len(data):
            # a corrupt count would otherwise build a multi-GB struct
            # format string below
            raise ValueError(
                f"TIFF tag {tag}: {count} values exceed the file size")
        voff = e + (12 if big else 8)
        if size <= inline:
            payload = data[voff:voff + size]
        else:
            off, = struct.unpack(endian + ("Q" if big else "I"),
                                 data[voff:voff + (8 if big else 4)])
            payload = data[off:off + size]
        name = _TAGS.get(tag)
        if name is None:
            continue
        if typ == 2:  # ASCII
            tags[name] = payload.rstrip(b"\x00").decode("latin1")
        elif typ in _TYPE_FMT:
            fmt = _TYPE_FMT[typ]
            if typ == 5:  # RATIONAL
                vals = struct.unpack(endian + "II" * count, payload)
                tags[name] = [vals[2 * k] / vals[2 * k + 1] for k in range(count)]
            else:
                tags[name] = list(struct.unpack(endian + fmt * count, payload))
        else:
            tags[name] = payload

    width = tags["ImageWidth"][0]
    height = tags["ImageLength"][0]
    spp = tags.get("SamplesPerPixel", [1])[0]
    if spp != 1:
        raise ValueError("only single-band GeoTIFFs supported")
    bits = tags.get("BitsPerSample", [8])[0]
    fmt = tags.get("SampleFormat", [1])[0]
    compression = tags.get("Compression", [1])[0]
    predictor = tags.get("Predictor", [1])[0]
    dtype = _sample_dtype(bits, fmt, endian)
    bpp = bits // 8
    # allocation guard: absolute, NOT a compression-ratio bound — deflate
    # exceeds 1000:1 on uniform data (e.g. this repo's own mask rasters),
    # so a ratio test rejects valid files; the bomb being stopped is the
    # corrupt-dims astronomic alloc
    if (height > 1_000_000 or width > 1_000_000
            or float(height) * width * bpp > 8e9):
        raise ValueError(
            f"implausible TIFF dimensions {width}x{height}x{bpp}B")

    out = np.zeros((height, width), dtype=dtype)
    if "TileOffsets" in tags:
        tw, th = tags["TileWidth"][0], tags["TileLength"][0]
        if tw > 1_000_000 or th > 1_000_000 or float(tw) * th * bpp > 8e9:
            raise ValueError(f"implausible TIFF tile size {tw}x{th}")
        offs = tags["TileOffsets"]
        cnts = tags["TileByteCounts"]
        tiles_across = -(-width // tw)
        for ti, (o, c) in enumerate(zip(offs, cnts)):
            raw = _decompress(data[o:o + c], compression, tw * th * bpp)
            if predictor == 3:
                if dtype.kind != "f":
                    raise ValueError("fp predictor on non-float samples")
                raw = _unpredict_fp(raw, tw, bpp)
                tile = np.frombuffer(raw, dtype=f">f{bpp}",
                                     count=tw * th).reshape(th, tw)
                tile = tile.astype(dtype.newbyteorder("="))
            else:
                tile = np.frombuffer(raw, dtype=dtype,
                                     count=tw * th).reshape(th, tw)
                tile = _unpredict(tile.copy(), predictor)
            r0 = (ti // tiles_across) * th
            c0 = (ti % tiles_across) * tw
            out[r0:r0 + th, c0:c0 + tw] = tile[: height - r0, : width - c0]
    else:
        rps = tags.get("RowsPerStrip", [height])[0]
        offs = tags["StripOffsets"]
        cnts = tags["StripByteCounts"]
        row = 0
        for o, c in zip(offs, cnts):
            nrows = min(rps, height - row)
            raw = _decompress(data[o:o + c], compression, nrows * width * bpp)
            if predictor == 3:
                if dtype.kind != "f":
                    raise ValueError("fp predictor on non-float samples")
                raw = _unpredict_fp(raw, width, bpp)
                strip = np.frombuffer(raw, dtype=f">f{bpp}",
                                      count=nrows * width).reshape(nrows,
                                                                   width)
                strip = strip.astype(dtype.newbyteorder("="))
            else:
                strip = np.frombuffer(raw, dtype=dtype,
                                      count=nrows * width).reshape(nrows,
                                                                   width)
                strip = _unpredict(strip.copy(), predictor)
            out[row:row + nrows] = strip
            row += nrows

    # georeferencing
    if "ModelTransformation" in tags:
        m = tags["ModelTransformation"]
        transform = Affine(m[0], m[1], m[3], m[4], m[5], m[7])
    elif "ModelPixelScale" in tags and "ModelTiepoint" in tags:
        sx, sy = tags["ModelPixelScale"][:2]
        tp = tags["ModelTiepoint"]
        # tiepoint: raster (i, j, k) -> model (x, y, z)
        i, j, _, x, y, _ = tp[:6]
        transform = Affine(sx, 0, x - i * sx, 0, -sy, y + j * sy)
    else:
        transform = Affine(1, 0, 0, 0, -1, height)

    crs = 4326
    if "GeoKeyDirectory" in tags:
        gk = tags["GeoKeyDirectory"]
        keys = {gk[4 + 4 * k]: gk[7 + 4 * k] for k in range((len(gk) - 4) // 4)}
        # 3072 = ProjectedCSTypeGeoKey, 2048 = GeographicTypeGeoKey
        crs = keys.get(3072) or keys.get(2048) or 4326
        if crs == 32767:
            # GeoTIFF "user-defined": parameters live in other geokeys we
            # don't reconstruct — fail at read time with a clear message
            # instead of a baffling 'transform 32767 -> ...' later
            raise ValueError(
                "GeoTIFF declares a user-defined CRS (GeoKey 32767); "
                "re-export with an EPSG code or build the Raster with an "
                "explicit crs= key")

    nodata = None
    if "GDALNoData" in tags:
        try:
            nodata = float(tags["GDALNoData"])
        except ValueError:
            nodata = None

    # no GDALNoData tag -> nodata stays unset (rasterio/GDAL behavior);
    # defaulting to 255 silently dropped legitimate 255-valued pixels
    # from average reprojections
    return Raster(out, transform, crs=crs, nodata=nodata)


def write_geotiff(raster, path, compression="deflate"):
    """Write a single-band GeoTIFF (striped, Deflate or uncompressed)."""
    from atlite_tpu_torch.gis.crs import normalize_crs

    t0 = raster.transform
    if t0.e > 0:
        # GeoTIFF's ModelPixelScale + top-left tiepoint encoding assumes
        # north-up (negative e); normalize ascending-y rasters by flipping
        # rows and re-anchoring the origin at the top — the georeferencing
        # round-trips exactly instead of silently mirroring
        from atlite_tpu_torch.core.grid import Affine
        from atlite_tpu_torch.gis.raster import Raster as _R

        rows = np.asarray(raster.data).shape[0]
        raster = _R(
            np.asarray(raster.data)[::-1],
            Affine(t0.a, t0.b, t0.c, t0.d, -t0.e, t0.f + t0.e * rows),
            raster.crs, raster.nodata,
        )
    arr = np.ascontiguousarray(raster.data)
    if arr.ndim != 2:
        raise ValueError("single-band rasters only")
    t_chk = raster.transform
    if t_chk.b != 0 or t_chk.d != 0 or t_chk.a <= 0:
        # ModelPixelScale cannot carry rotation/shear or descending x —
        # writing abs() values would silently mislocate the raster
        raise ValueError(
            "write_geotiff requires an axis-aligned north-up/ascending-x "
            f"transform, got {t_chk}")
    height, width = arr.shape
    dt = arr.dtype
    fmt = {"u": 1, "i": 2, "f": 3}[dt.kind]
    bits = dt.itemsize * 8
    payload = arr.astype(dt.newbyteorder("<")).tobytes()
    if compression == "deflate":
        comp_code = 8
        payload = zlib.compress(payload, 6)
    elif compression == "lzw":
        comp_code = 5
        payload = _lzw_encode(payload)
    elif compression == "packbits":
        comp_code = 32773
        payload = _packbits_encode(payload)
    elif compression in (None, "none"):
        comp_code = 1
    else:
        raise ValueError(f"unsupported compression {compression!r}")

    t = raster.transform
    crs = normalize_crs(raster.crs)
    if not isinstance(crs, int):
        # GeoTIFF geokeys can only carry EPSG codes; stamping 4326 on a
        # 'cea'/proj4-tuple raster would silently mislabel meters as
        # degrees
        raise ValueError(
            f"write_geotiff can only encode EPSG-coded CRSs, got {crs!r}; "
            "save as .npz (Raster.save) to keep a parameterized CRS")
    # GeoKeyDirectory: version, rev, minor, nkeys, then (key, loc, cnt, val)
    is_geographic = crs == 4326 or 4000 <= crs < 5000
    geokeys = [1, 1, 0, 3,
               1024, 0, 1, 2 if is_geographic else 1,   # GTModelType
               1025, 0, 1, 1,                            # RasterPixelIsArea
               (2048 if is_geographic else 3072), 0, 1, crs]

    entries = []  # (tag, type, count, values)
    entries.append((256, 3, 1, [width]))
    entries.append((257, 3, 1, [height]))
    entries.append((258, 3, 1, [bits]))
    entries.append((259, 3, 1, [comp_code]))
    entries.append((262, 3, 1, [1]))
    entries.append((277, 3, 1, [1]))
    entries.append((278, 3, 1, [height]))  # one strip
    entries.append((279, 4, 1, [len(payload)]))
    entries.append((339, 3, 1, [fmt]))
    entries.append((33550, 12, 3, [abs(t.a), abs(t.e), 0.0]))
    entries.append((33922, 12, 6, [0.0, 0.0, 0.0, t.c, t.f, 0.0]))
    entries.append((34735, 3, len(geokeys), geokeys))
    if raster.nodata is not None:
        nod = (f"{raster.nodata:.10g}").encode() + b"\x00"
        entries.append((42113, 2, len(nod), nod))
    entries.append((273, 4, 1, None))  # StripOffsets patched below

    entries.sort(key=lambda e: e[0])
    header_size = 8
    ifd_size = 2 + 12 * len(entries) + 4
    # out-of-line data area after the IFD
    extra = bytearray()
    extra_base = header_size + ifd_size

    def encode_values(typ, values):
        if typ == 2:
            return bytes(values)
        fmt_c = {3: "H", 4: "I", 12: "d"}[typ]
        return struct.pack("<" + fmt_c * len(values), *values)

    ifd = struct.pack("<H", len(entries))
    for tag, typ, count, values in entries:
        if values is None:  # StripOffsets placeholder (patched below)
            ifd += struct.pack("<HHI", tag, typ, count)
            ifd += struct.pack("<I", 0)
            continue
        enc = encode_values(typ, values)
        ifd += struct.pack("<HHI", tag, typ, count)
        if len(enc) <= 4:
            ifd += enc + b"\x00" * (4 - len(enc))
        else:
            ifd += struct.pack("<I", extra_base + len(extra))
            extra += enc
            if len(extra) % 2:
                extra += b"\x00"
    ifd += struct.pack("<I", 0)  # next IFD

    data_offset = extra_base + len(extra)
    # patch StripOffsets value
    ifd = bytearray(ifd)
    # find the StripOffsets entry again to patch its value field
    pos = 2
    for tag, typ, count, values in entries:
        if values is None:
            struct.pack_into("<I", ifd, pos + 8, data_offset)
        pos += 12

    header = b"II" + struct.pack("<HI", 42, header_size)
    Path(path).write_bytes(header + bytes(ifd) + bytes(extra) + payload)
