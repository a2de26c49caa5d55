"""Minimal ctypes binding to the system libsz (szip/libaec) for HDF5
filter id 4.

Older NCEP/NASA NetCDF4 archives ship szip-compressed; the reference
gets this free from libhdf5.  The filter's chunk layout follows
libhdf5's H5Zszip.c: 4 little-endian bytes of stored (uncompressed)
size, then the szip stream; the four client-data values carry
(options_mask, bits_per_pixel, pixels_per_block, pixels_per_scanline).
Validated against h5py/libhdf5-written fixtures in tests/test_netcdf.py.

A copy of ``atlite_tpu/io/szip.py``; without the library it raises as
the JAX one does.
"""

from __future__ import annotations

import ctypes
import ctypes.util

_lib = None
SZ_OK = 0


class _SZParam(ctypes.Structure):
    _fields_ = [
        ("options_mask", ctypes.c_int),
        ("bits_per_pixel", ctypes.c_int),
        ("pixels_per_block", ctypes.c_int),
        ("pixels_per_scanline", ctypes.c_int),
    ]


def _load():
    global _lib
    if _lib is None:
        name = ctypes.util.find_library("sz") or "libsz.so.2"
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            _lib = False
            return False
        lib.SZ_BufftoBuffDecompress.restype = ctypes.c_int
        lib.SZ_BufftoBuffDecompress.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_size_t),
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(_SZParam),
        ]
        _lib = lib
    return _lib


def available():
    return bool(_load())


def decompress(data, cd_values, max_out):
    """Decompress one H5Zszip chunk; output capped at ``max_out``."""
    lib = _load()
    if not lib:
        raise NotImplementedError(
            "szip-compressed data but libsz is not available")
    if len(data) < 4 or len(cd_values) < 4:
        raise ValueError("corrupt szip chunk/filter parameters")
    stored = int.from_bytes(data[:4], "little")
    if stored > max_out:
        raise ValueError(
            f"szip chunk inflates to {stored} bytes, expected <= {max_out}")
    dest = ctypes.create_string_buffer(max(stored, 1))
    destlen = ctypes.c_size_t(stored)
    # stored client-data order (empirical, pinned against libhdf5-written
    # files): [options_mask, pixels_per_block, bits_per_pixel,
    # pixels_per_scanline]
    param = _SZParam(int(cd_values[0]), int(cd_values[2]),
                     int(cd_values[1]), int(cd_values[3]))
    rc = lib.SZ_BufftoBuffDecompress(dest, ctypes.byref(destlen),
                                     bytes(data[4:]), len(data) - 4,
                                     ctypes.byref(param))
    if rc != SZ_OK:
        raise ValueError(f"corrupt szip stream (rc={rc})")
    return dest.raw[:destlen.value]
