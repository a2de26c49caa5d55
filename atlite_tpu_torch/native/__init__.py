"""ctypes bindings of the C++ host geometry engine (counterpart of
``atlite_tpu/native/__init__.py``): ``polygon_cell_areas``, the cell
areas of the indicator matrix, and ``points_in_polygon`` (the engine's
``points_in_rings``), the even-odd pixel test of ``gis.raster.geometry_mask``.

``geometry.cpp`` is compiled with ``g++ -O3 -fPIC -shared -std=c++17`` at
first use into ``build/native/libatlite_geom_<hash>.so`` at the root of the
checkout, where ``<hash>`` covers the source and the flags, so an edited
source is rebuilt and a stale library is never loaded.  Where it cannot
be built or loaded (no ``g++``, a failed build), ``get_lib`` logs one
warning and returns None, and the callers use the numpy versions in
``gis.geometry``.  ``ATLITE_TPU_NO_NATIVE=1`` forces the numpy versions,
as in the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / "geometry.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
_lib = None
_tried = False


def library_path() -> Path:
    """Where the engine's library lives once built."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libatlite_geom_{h.hexdigest()[:16]}.so"


def _build(out: Path):
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        r = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"g++ exit {r.returncode}: {r.stderr.strip()[:500]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib():
    """The loaded engine (built on first use), or None."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("ATLITE_TPU_NO_NATIVE"):
        return None
    try:
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
    except (OSError, RuntimeError, subprocess.TimeoutExpired) as exc:
        logger.warning("the C++ geometry engine did not build or load (%s); the GIS "
                       "matrices use the numpy versions, which are far slower", exc)
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
