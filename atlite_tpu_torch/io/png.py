"""Minimal PNG codec (grayscale/RGB/RGBA, 8/16-bit) for GRIB2 data
representation template 5.41 (PNG packing).

eccodes' grib_png packing stores the packed integer field as one PNG
image: bits<=8 -> 8-bit grayscale, <=16 -> 16-bit grayscale, <=24 -> RGB,
else RGBA, with the sample's bytes spread big-endian across channels.
This implements the container: chunk framing, zlib inflate, scanline
unfiltering (types 0-4) — validated against Pillow in tests/test_grib.py.

A copy of ``atlite_tpu/io/png.py``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
# color type -> channels
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def decode(data):
    """Decode a PNG byte stream to (height, width, channels) uint8/uint16."""
    if data[:8] != _SIG:
        raise ValueError("not a PNG stream")
    pos = 8
    ihdr = None
    idat = []
    while pos + 8 <= len(data):
        ln = int.from_bytes(data[pos:pos + 4], "big")
        typ = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + ln]
        if len(body) < ln:
            raise ValueError("truncated PNG chunk")
        if typ == b"IHDR":
            ihdr = body
        elif typ == b"IDAT":
            idat.append(body)
        elif typ == b"IEND":
            break
        pos += 12 + ln  # len + type + data + crc
    if ihdr is None or not idat:
        raise ValueError("PNG missing IHDR/IDAT")
    w, h = struct.unpack(">II", ihdr[:8])
    depth, color, comp, filt, interlace = ihdr[8:13]
    if comp != 0 or filt != 0 or interlace != 0:
        raise NotImplementedError("PNG compression/filter/interlace variant")
    if depth not in (8, 16) or color not in _CHANNELS:
        raise NotImplementedError(f"PNG depth {depth} color type {color}")
    ch = _CHANNELS[color]
    bpp = (depth // 8) * ch
    stride = w * bpp
    if h > 100_000 or w > 100_000 or h * stride > 2_000_000_000:
        raise ValueError(f"implausible PNG dimensions {w}x{h}")
    try:
        d = zlib.decompressobj()
        raw = d.decompress(b"".join(idat), h * (stride + 1) + 1)
    except zlib.error as exc:
        raise ValueError(f"corrupt PNG pixel data: {exc}") from exc
    if len(raw) < h * (stride + 1):
        raise ValueError("PNG pixel data decoded short")

    out = np.empty((h, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    for r in range(h):
        ftype = raw[r * (stride + 1)]
        line = np.frombuffer(raw, dtype=np.uint8, count=stride,
                             offset=r * (stride + 1) + 1).copy()
        if ftype == 0:
            pass
        elif ftype == 1:  # Sub: per-offset-class cumulative sum mod 256
            line = (np.cumsum(line.reshape(-1, bpp), axis=0,
                              dtype=np.uint64) % 256) \
                .astype(np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            line = (line.astype(np.uint16) + prev) \
                .astype(np.uint8)
        elif ftype == 3:  # Average (left is sequential)
            ln = line.astype(np.int32)
            rec = np.empty(stride, dtype=np.int32)
            pv = prev.astype(np.int32)
            for i in range(stride):
                left = rec[i - bpp] if i >= bpp else 0
                rec[i] = (ln[i] + (left + pv[i]) // 2) & 0xFF
            line = rec.astype(np.uint8)
        elif ftype == 4:  # Paeth (sequential)
            ln = line.astype(np.int32)
            rec = np.empty(stride, dtype=np.int32)
            pv = prev.astype(np.int32)
            for i in range(stride):
                a = rec[i - bpp] if i >= bpp else 0
                b = pv[i]
                c = pv[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                rec[i] = (ln[i] + pred) & 0xFF
            line = rec.astype(np.uint8)
        else:
            raise ValueError(f"PNG filter type {ftype}")
        out[r] = line
        prev = out[r]
    if depth == 16:
        arr = out.reshape(h, w, ch, 2)
        arr = (arr[..., 0].astype(np.uint16) << 8) | arr[..., 1]
        return arr
    return out.reshape(h, w, ch)


def encode(arr):
    """Encode (h, w, ch) uint8/uint16 as PNG (filter 0 scanlines)."""
    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, ch = arr.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    if arr.dtype == np.uint16:
        depth = 16
        raw = arr.astype(">u2").tobytes()
    else:
        depth = 8
        raw = arr.astype(np.uint8).tobytes()
    stride = w * (depth // 8) * ch
    lines = b"".join(b"\x00" + raw[r * stride:(r + 1) * stride]
                     for r in range(h))

    def chunk(typ, body):
        crc = zlib.crc32(typ + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + typ + body \
            + struct.pack(">I", crc)

    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    return (_SIG + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(lines, 6))
            + chunk(b"IEND", b""))
