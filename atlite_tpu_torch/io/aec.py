"""Minimal ctypes binding to the system libaec (CCSDS 121.0-B Rice
coding) for GRIB2 data-representation template 5.42.

CCSDS packing is eccodes' preferred lossless packing for a growing set
of CDS/ECMWF GRIB2 products (grib_ccsds); the reference decodes it
through eccodes, which links this same library.  The binding is
encode/decode symmetric so fixtures round-trip through the real codec.

A copy of ``atlite_tpu/io/aec.py``; without the library it raises as the
JAX one does.
"""

from __future__ import annotations

import ctypes
import ctypes.util

AEC_OK = 0
# option flags (libaec.h)
AEC_DATA_SIGNED = 1
AEC_DATA_3BYTE = 2
AEC_DATA_MSB = 4
AEC_DATA_PREPROCESS = 8

_lib = None


class _Stream(ctypes.Structure):
    _fields_ = [
        ("next_in", ctypes.c_char_p),
        ("avail_in", ctypes.c_size_t),
        ("total_in", ctypes.c_size_t),
        ("next_out", ctypes.c_void_p),
        ("avail_out", ctypes.c_size_t),
        ("total_out", ctypes.c_size_t),
        ("bits_per_sample", ctypes.c_uint),
        ("block_size", ctypes.c_uint),
        ("rsi", ctypes.c_uint),
        ("flags", ctypes.c_uint),
        ("state", ctypes.c_void_p),
    ]


def _load():
    global _lib
    if _lib is None:
        name = ctypes.util.find_library("aec") or "libaec.so.0"
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            _lib = False
            return False
        for fn in ("aec_buffer_decode", "aec_buffer_encode"):
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = [ctypes.POINTER(_Stream)]
        _lib = lib
    return _lib


def available():
    return bool(_load())


def _run(fn_name, data, out_size, bits_per_sample, block_size, rsi, flags):
    lib = _load()
    if not lib:
        raise NotImplementedError(
            "CCSDS/AEC-packed data but libaec is not available")
    out = ctypes.create_string_buffer(max(int(out_size), 1))
    strm = _Stream(
        next_in=bytes(data), avail_in=len(data), total_in=0,
        next_out=ctypes.cast(out, ctypes.c_void_p), avail_out=len(out),
        total_out=0, bits_per_sample=int(bits_per_sample),
        block_size=int(block_size), rsi=int(rsi), flags=int(flags),
        state=None,
    )
    rc = getattr(lib, fn_name)(ctypes.byref(strm))
    if rc != AEC_OK:
        raise ValueError(f"libaec {fn_name} failed (rc={rc})")
    return out.raw[:strm.total_out]


def sample_nbytes(bits_per_sample, flags):
    """Bytes per decoded sample: the eccodes rule (1/2/4) unless the
    stream's AEC_DATA_3BYTE flag packs 17-24-bit samples into 3 bytes."""
    if bits_per_sample > 16:
        if bits_per_sample <= 24 and (flags & AEC_DATA_3BYTE):
            return 3
        return 4
    return 2 if bits_per_sample > 8 else 1


def decode(data, nsamples, bits_per_sample, block_size, rsi, flags):
    """Decode a CCSDS stream to ``nsamples`` packed samples; returns the
    raw sample bytes (width per sample_nbytes, byte order per the
    stream's AEC_DATA_MSB flag — the caller must honor both)."""
    nbytes = sample_nbytes(bits_per_sample, flags)
    if nsamples < 0 or nsamples > 100_000_000:
        raise ValueError(f"implausible CCSDS sample count {nsamples}")
    return _run("aec_buffer_decode", data, nsamples * nbytes,
                bits_per_sample, block_size, rsi, flags)


def encode(sample_bytes, bits_per_sample, block_size, rsi, flags):
    return _run("aec_buffer_encode", sample_bytes,
                2 * len(sample_bytes) + 4096,
                bits_per_sample, block_size, rsi, flags)
