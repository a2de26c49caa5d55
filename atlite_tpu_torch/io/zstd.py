"""Minimal ctypes binding to the system libzstd (no pip package needed).

Serves HDF5 filter id 32015 (zstd) in io/hdf5.py — new-CDS NetCDF4 files
increasingly use it (CONFORMANCE.md residual risk 5; the reference gets
this for free through the libhdf5 plugin path).  The binding is
read/write symmetric so test fixtures can be generated without the h5py
zstd plugin.

A copy of ``atlite_tpu/io/zstd.py``; without the library it raises as
the JAX one does.
"""

from __future__ import annotations

import ctypes
import ctypes.util

_lib = None
_CONTENTSIZE_UNKNOWN = 2**64 - 1
_CONTENTSIZE_ERROR = 2**64 - 2


def _load():
    global _lib
    if _lib is None:
        name = ctypes.util.find_library("zstd") or "libzstd.so.1"
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            _lib = False
            return False
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
        lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_char_p,
                                                 ctypes.c_size_t]
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_decompress.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                        ctypes.c_char_p, ctypes.c_size_t]
        lib.ZSTD_compressBound.restype = ctypes.c_size_t
        lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
        lib.ZSTD_compress.restype = ctypes.c_size_t
        lib.ZSTD_compress.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                      ctypes.c_char_p, ctypes.c_size_t,
                                      ctypes.c_int]
        _lib = lib
    return _lib


def available():
    return bool(_load())


def decompress(data, max_out):
    """Decompress one zstd frame; output capped at ``max_out`` bytes
    (the HDF5 chunk's nominal size — bomb protection at the codec trust
    boundary)."""
    lib = _load()
    if not lib:
        raise NotImplementedError(
            "zstd-compressed data but libzstd is not available")
    data = bytes(data)
    content = lib.ZSTD_getFrameContentSize(data, len(data))
    if content == _CONTENTSIZE_ERROR:
        raise ValueError("corrupt zstd frame header")
    if content == _CONTENTSIZE_UNKNOWN:
        content = max_out
    if content > max_out:
        raise ValueError(
            f"zstd frame inflates to {content} bytes, expected <= {max_out}")
    dst = ctypes.create_string_buffer(int(content) or 1)
    n = lib.ZSTD_decompress(dst, int(content), data, len(data))
    if lib.ZSTD_isError(n):
        raise ValueError("corrupt zstd frame")
    return dst.raw[:n]


def compress(data, level=3):
    lib = _load()
    if not lib:
        raise NotImplementedError("libzstd is not available")
    data = bytes(data)
    cap = lib.ZSTD_compressBound(len(data))
    dst = ctypes.create_string_buffer(cap)
    n = lib.ZSTD_compress(dst, cap, data, len(data), int(level))
    if lib.ZSTD_isError(n):
        raise ValueError("zstd compression failed")
    return dst.raw[:n]
