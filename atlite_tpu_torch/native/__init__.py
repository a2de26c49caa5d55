"""ctypes bindings of the port's C++ host code.

- The geometry engine (counterpart of ``atlite_tpu/native/__init__.py``):
  ``polygon_cell_areas``, the cell areas of the indicator matrix, and
  ``points_in_polygon`` (the engine's ``points_in_rings``), the even-odd
  pixel test of ``gis.raster.geometry_mask``.
- The streamer's int16 pack (``pack16.cpp``): ``pack16`` turns the time
  fields of a chunk into CF int16 codes on the host's cores, as
  ``Cutout._pack``'s numpy loop does on one.

Each source is compiled with ``g++ -O3 -fPIC -shared -std=c++17`` (the
pack adds ``-pthread -ffp-contract=off``) at first use into
``build/native/lib<name>_<hash>.so`` at the root of the checkout, where
``<hash>`` covers the source and the flags, so an edited source is rebuilt
and a stale library is never loaded.  Where it cannot be built or loaded
(no ``g++``, a failed build), ``get_lib`` / ``get_pack_lib`` log one
warning and return None, and the callers use the numpy versions (in
``gis.geometry``, and ``Cutout._pack``'s loop).  ``ATLITE_TPU_NO_NATIVE=1``
forces the numpy versions, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / "geometry.cpp"
PACK_SOURCE = SOURCE.with_name("pack16.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
# no -ffast-math, and no contraction into fused multiply-adds: each step of
# the pack rounds as numpy's does
PACK_FLAGS = (*CXX_FLAGS, "-pthread", "-ffp-contract=off")
# the fewest elements of a field a pack thread takes: below, a thread's
# start costs more than its share of the work
MIN_PACK_BLOCK = 1 << 16
_lib = _pack_lib = None
_tried = _pack_tried = False
_pack_lock = threading.Lock()  # the streamer's worker loads the pack


def _library_path(name, source, flags) -> Path:
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def library_path() -> Path:
    """Where the engine's library lives once built."""
    return _library_path("atlite_geom", SOURCE, CXX_FLAGS)


def _build(out: Path, source=SOURCE, flags=CXX_FLAGS):
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        r = subprocess.run([cxx, *flags, "-o", tmp, str(source)],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"g++ exit {r.returncode}: {r.stderr.strip()[:500]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load(path, source, flags, fallback):
    """The library at ``path``, built from ``source`` first if missing;
    None (and one warning naming ``fallback``) where it cannot be."""
    try:
        if not path.exists():
            _build(path, source, flags)
        return ctypes.CDLL(str(path))
    except (OSError, RuntimeError, subprocess.TimeoutExpired) as exc:
        logger.warning("the C++ %s did not build or load (%s); %s", source.name, exc, fallback)
        return None


def get_lib():
    """The loaded engine (built on first use), or None."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("ATLITE_TPU_NO_NATIVE"):
        return None
    lib = _load(library_path(), SOURCE, CXX_FLAGS,
                "the GIS matrices use the numpy versions, which are far slower")
    if lib is None:
        return None
    dp, ip = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64)
    lib.polygon_cell_areas.argtypes = [
        dp, dp, ip, ctypes.c_int64, ctypes.c_double, ctypes.c_double, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_int64, dp]
    lib.polygon_cell_areas.restype = None
    lib.points_in_rings.argtypes = [dp, dp, ip, ctypes.c_int64, dp, dp, ctypes.c_int64,
                                    ctypes.POINTER(ctypes.c_uint8)]
    lib.points_in_rings.restype = None
    _lib = lib
    return _lib


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _rings_arrays(polygon):
    """A Polygon's rings as contiguous (xs, ys, sizes) arrays."""
    rings = [polygon.shell, *polygon.holes]
    xs = np.ascontiguousarray(np.concatenate([r[:, 0] for r in rings]))
    ys = np.ascontiguousarray(np.concatenate([r[:, 1] for r in rings]))
    sizes = np.asarray([len(r) for r in rings], dtype=np.int64)
    return xs, ys, sizes


def polygon_cell_areas(polygon, x0, dx, nx, y0, dy, ny, out=None):
    """|polygon ∩ cell| for every cell of a regular window, (ny, nx)
    float64, accumulated into ``out`` when given; None without the
    engine."""
    lib = get_lib()
    if lib is None:
        return None
    xs, ys, sizes = _rings_arrays(polygon)
    if out is None:
        out = np.zeros((ny, nx), dtype=np.float64)
    if out.shape != (ny, nx) or out.dtype != np.float64 or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous float64 ({ny}, {nx}) array")
    lib.polygon_cell_areas(
        _dp(xs), _dp(ys), sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(sizes), ctypes.c_double(x0), ctypes.c_double(dx), nx,
        ctypes.c_double(y0), ctypes.c_double(dy), ny, _dp(out))
    return out



def points_in_polygon(polygon, px, py, out=None):
    """Even-odd point-in-polygon of one Polygon (shell and holes) over flat
    point arrays, XORed into the uint8 ``out`` when given; None without the
    engine."""
    lib = get_lib()
    if lib is None:
        return None
    xs, ys, sizes = _rings_arrays(polygon)
    px = np.ascontiguousarray(px, dtype=np.float64)
    py = np.ascontiguousarray(py, dtype=np.float64)
    if out is None:
        out = np.zeros(px.shape, dtype=np.uint8)
    if out.shape != px.shape or out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous uint8 array of shape {px.shape}")
    lib.points_in_rings(
        _dp(xs), _dp(ys), sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(sizes), _dp(px), _dp(py), px.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out


# ------------------------------------------------------------ int16 pack
def get_pack_lib():
    """The loaded int16 pack (built on first use), or None."""
    global _pack_lib, _pack_tried
    with _pack_lock:
        if _pack_tried:
            return _pack_lib
        _pack_tried = True
        if os.environ.get("ATLITE_TPU_NO_NATIVE"):
            return None
        lib = _load(_library_path("atlite_pack16", PACK_SOURCE, PACK_FLAGS), PACK_SOURCE,
                    PACK_FLAGS, "int16 streaming packs with numpy on one thread")
        if lib is None:
            return None
        vp, dp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.pack16.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(vp), u8p, dp, dp,
                               u8p, ctypes.POINTER(vp), ctypes.c_int64, dp, dp]
        lib.pack16.restype = None
        _pack_lib = lib
        return _pack_lib


def pack_threads(n):
    """Threads for a pack of ``n``-element fields: the cores this process
    may run on, but no block under ``MIN_PACK_BLOCK`` elements."""
    return max(1, min(len(os.sched_getaffinity(0)), n // MIN_PACK_BLOCK))


def pack16(sources, params, out, threads=None):
    """CF int16 codes of the arrays ``sources`` into the uint16 ``out``
    (fields first, C-contiguous, ``out[i]`` of ``sources[i]``'s size), with
    ``params[i]`` = (offset, scale, log_space) as ``Cutout.pack_params``
    gives them, on ``threads`` threads (default ``pack_threads``).  Returns
    each field's NaN-ignoring (min, max) of ``(value - offset) / scale``
    (NaN where every value is NaN), or None without the library.  A source
    that is not C-contiguous float32 or float64 is made so first."""
    lib = get_pack_lib()
    if lib is None:
        return None
    nf = len(sources)
    if out.dtype != np.uint16 or not out.flags.c_contiguous or len(out) != nf:
        raise ValueError(f"out must be a C-contiguous uint16 array of {nf} fields")
    if len(params) != nf:
        raise ValueError(f"{len(params)} pack parameters for {nf} fields")
    n = out[0].size if nf else 0
    srcs = []
    for a in sources:
        a = np.asarray(a)
        if a.dtype not in (np.float32, np.float64):
            a = a.astype(np.float64)
        a = np.ascontiguousarray(a)
        if a.size != n:
            raise ValueError(f"a source of {a.size} elements for fields of {n}")
        srcs.append(a)
    threads = pack_threads(n) if threads is None else int(threads)
    lo, hi = (ctypes.c_double * nf)(), (ctypes.c_double * nf)()
    lib.pack16(nf, n, (ctypes.c_void_p * nf)(*(a.ctypes.data for a in srcs)),
               (ctypes.c_uint8 * nf)(*(a.dtype == np.float64 for a in srcs)),
               (ctypes.c_double * nf)(*(float(p[0]) for p in params)),
               (ctypes.c_double * nf)(*(float(p[1]) for p in params)),
               (ctypes.c_uint8 * nf)(*(bool(p[2]) for p in params)),
               (ctypes.c_void_p * nf)(*(o.ctypes.data for o in out)), threads, lo, hi)
    return list(zip(lo, hi))
