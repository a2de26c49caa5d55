"""Minimal ctypes binding to the system libopenjp2 (JPEG 2000) for GRIB2
data-representation template 5.40.

eccodes decodes jpeg-packed GRIB2 fields through this same library
(grib_jpeg via openjpeg; the reference's path,
datasets/era5.py:381-395 delegates to cfgrib/eccodes).  GRIB embeds a raw J2K
CODESTREAM (not a .jp2 container) holding one grayscale component of
non-negative integers.  Decoding goes through a temp file +
``opj_stream_create_default_file_stream`` — openjpeg's in-memory stream
API needs C callbacks, and the file path is the same code the openjpeg
tools exercise.  Malformed input fails as ValueError in bounded time
(tests/test_codec_fuzz.py).

A copy of ``atlite_tpu/io/jp2.py``; without the library it raises as the
JAX one does.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import tempfile

OPJ_CODEC_J2K = 0

_lib = None


class _ImageComp(ctypes.Structure):
    # opj_image_comp_t, openjpeg.h (2.x ABI)
    _fields_ = [
        ("dx", ctypes.c_uint32),
        ("dy", ctypes.c_uint32),
        ("w", ctypes.c_uint32),
        ("h", ctypes.c_uint32),
        ("x0", ctypes.c_uint32),
        ("y0", ctypes.c_uint32),
        ("prec", ctypes.c_uint32),
        ("bpp", ctypes.c_uint32),
        ("sgnd", ctypes.c_uint32),
        ("resno_decoded", ctypes.c_uint32),
        ("factor", ctypes.c_uint32),
        ("data", ctypes.POINTER(ctypes.c_int32)),
        ("alpha", ctypes.c_uint16),
    ]


class _Image(ctypes.Structure):
    # opj_image_t, openjpeg.h (2.x ABI)
    _fields_ = [
        ("x0", ctypes.c_uint32),
        ("y0", ctypes.c_uint32),
        ("x1", ctypes.c_uint32),
        ("y1", ctypes.c_uint32),
        ("numcomps", ctypes.c_uint32),
        ("color_space", ctypes.c_int),
        ("comps", ctypes.POINTER(_ImageComp)),
        ("icc_profile_buf", ctypes.c_void_p),
        ("icc_profile_len", ctypes.c_uint32),
    ]


def _load():
    global _lib
    if _lib is None:
        name = ctypes.util.find_library("openjp2") or "libopenjp2.so.7"
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            _lib = False
            return False
        lib.opj_create_decompress.restype = ctypes.c_void_p
        lib.opj_create_decompress.argtypes = [ctypes.c_int]
        lib.opj_destroy_codec.argtypes = [ctypes.c_void_p]
        lib.opj_set_default_decoder_parameters.argtypes = [ctypes.c_void_p]
        lib.opj_setup_decoder.restype = ctypes.c_int
        lib.opj_setup_decoder.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.opj_stream_create_default_file_stream.restype = ctypes.c_void_p
        lib.opj_stream_create_default_file_stream.argtypes = [
            ctypes.c_char_p, ctypes.c_int]
        lib.opj_stream_destroy.argtypes = [ctypes.c_void_p]
        lib.opj_read_header.restype = ctypes.c_int
        lib.opj_read_header.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.POINTER(_Image))]
        lib.opj_decode.restype = ctypes.c_int
        lib.opj_decode.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(_Image)]
        lib.opj_end_decompress.restype = ctypes.c_int
        lib.opj_end_decompress.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.opj_image_destroy.argtypes = [ctypes.POINTER(_Image)]
        _lib = lib
    return _lib


def available():
    return bool(_load())


def decode(data: bytes, max_pixels: int = 100_000_000):
    """Decode a raw J2K codestream into an int64 numpy array (h, w) of the
    first component.  Raises ValueError on malformed input."""
    import numpy as np

    lib = _load()
    if not lib:
        raise ValueError("system libopenjp2 not available for JPEG2000 "
                         "(GRIB2 DRS 5.40) decoding")
    if len(data) < 4 or data[:2] != b"\xff\x4f":  # SOC marker of a codestream
        raise ValueError("not a JPEG2000 (J2K) codestream")

    fd, path = tempfile.mkstemp(suffix=".j2k")
    codec = stream = None
    image = ctypes.POINTER(_Image)()
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(data)
        codec = lib.opj_create_decompress(OPJ_CODEC_J2K)
        if not codec:
            raise ValueError("openjpeg decoder creation failed")
        # opj_dparameters_t is ~9 KB (path char arrays); a zeroed 64 KB
        # buffer comfortably covers any 2.x layout
        params = ctypes.create_string_buffer(65536)
        lib.opj_set_default_decoder_parameters(params)
        if not lib.opj_setup_decoder(codec, params):
            raise ValueError("openjpeg decoder setup failed")
        stream = lib.opj_stream_create_default_file_stream(
            path.encode(), 1)
        if not stream:
            raise ValueError("openjpeg stream creation failed")
        if not lib.opj_read_header(stream, codec, ctypes.byref(image)):
            raise ValueError("malformed JPEG2000 codestream (header)")
        img = image.contents
        if img.numcomps < 1:
            raise ValueError("JPEG2000 codestream has no components")
        comp = img.comps[0]
        w, h = int(comp.w), int(comp.h)
        if w <= 0 or h <= 0 or w * h > max_pixels:
            raise ValueError(f"implausible JPEG2000 dimensions {w}x{h}")
        if not lib.opj_decode(codec, stream, image):
            raise ValueError("malformed JPEG2000 codestream (decode)")
        lib.opj_end_decompress(codec, stream)
        comp = image.contents.comps[0]
        if not comp.data:
            raise ValueError("JPEG2000 decode produced no data")
        out = np.ctypeslib.as_array(comp.data, shape=(h, w)).astype(np.int64)
        if comp.sgnd == 0 and comp.prec < 32:
            # non-negative samples; mask any sign-extension artifacts
            out &= (1 << int(comp.prec)) - 1
        return out
    finally:
        if stream:
            lib.opj_stream_destroy(stream)
        if codec:
            lib.opj_destroy_codec(codec)
        if image:
            lib.opj_image_destroy(image)
        try:
            os.unlink(path)
        except OSError:
            pass
