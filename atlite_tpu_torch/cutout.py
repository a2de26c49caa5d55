"""The Cutout: grid, prepared weather fields and converters (counterpart
of ``atlite_tpu/cutout.py``), in memory or in an ``.atc`` store.

The fields live on the host as numpy arrays (read-only memory maps of
the store's files when the cutout was reopened from disk) and are
mirrored as tensors on the cutout's device by ``fields()``, where the
converters run: each variable is staged when a call first reads it
(``_Fields``).  A time slice made by ``isel_time`` (the streamer's
chunk) stages all its time fields in one batched upload, raw or packed
as CF int16 codes (``pack_params``), and reuses its parent's staged
static fields; ``_stream_chunks`` stages the streamer's chunks that way,
one ahead, through the cutout's pinned ring (``core/device.PinnedRing``).

Every converter of the JAX Cutout is bound, the GIS members that build
aggregation matrices and layouts from shapes (``indicatormatrix``,
``intersectionmatrix``, ``area`` and the three layouts), the availability
matrix, the grid's metadata, ``sel``/``merge``/``equals`` and the store
(``prepare`` checkpoints each feature into it, ``to_file`` writes it).
A path ending in ``.nc`` is a NetCDF cutout (NETCDF4 or NetCDF-3, atlite's
own format): ``Cutout("x.nc")`` loads it whole into host arrays, and
``to_netcdf`` (or ``to_file``/``prepare`` on such a path) rewrites it
whole through a temporary file.
``shard(mesh)`` spreads the cutout over a ("t", "x") mesh of devices
(``core/mesh.py``): each mesh position gets a sub-cutout of a time slice
and an x slice, staged as ``isel_time`` stages one, and the converters
run block by block.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import shutil
import tempfile
import threading
import warnings
from collections.abc import Mapping, MutableMapping
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from time import perf_counter

import numpy as np
import torch

from atlite_tpu_torch import convert, native
from atlite_tpu_torch.core.device import PinnedRing, resolve_device
from atlite_tpu_torch.core.grid import Grid, coordinate_range
from atlite_tpu_torch.core.store import read_store, update_store, write_store
from atlite_tpu_torch.dataarray import DataArray
from atlite_tpu_torch.datasets import modules as datamodules
from atlite_tpu_torch.gis.crs import transform_points
from atlite_tpu_torch.gis.exclusion import compute_availabilitymatrix
from atlite_tpu_torch.gis.geometry import box
from atlite_tpu_torch.gis.matrix import compute_indicatormatrix, compute_intersectionmatrix
from atlite_tpu_torch.profiling import span
from atlite_tpu_torch.table import Table

logger = logging.getLogger(__name__)

_TORCH_DTYPE = {np.dtype("float32"): torch.float32, np.dtype("float64"): torch.float64}
NAN_CODE = 65535  # the packed NaN sentinel; codes of values run 0..65534


def _time_dims(var_attrs, name):
    dims = tuple(var_attrs.get(name, {}).get("dims", ("time", "y", "x")))
    return bool(dims) and dims[0] == "time"


def _pack_numpy(a, params, out):
    """The int16 codes of ``a`` into the uint16 ``out`` with ``params`` =
    (offset, scale, log_space), in numpy; returns the NaN-ignoring (min,
    max) of ``(value - offset) / scale`` (of the log in log space)."""
    off, scale, lg = params
    a = np.array(a, dtype=np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        if lg:
            np.log(a, out=a)
        np.subtract(a, off, out=a)
        np.divide(a, scale, out=a)
        lo, hi = np.fmin.reduce(a, axis=None), np.fmax.reduce(a, axis=None)
        np.rint(a, out=a)
        np.clip(a, 0.0, 65534.0, out=a)
    a[np.isnan(a)] = NAN_CODE
    out[...] = a
    return lo, hi


def _out_of_pack_range(name, codes, params):
    """The error of a variable whose codes (lo, hi), before rounding,
    leave 0..65534 by more than half a step: both ranges in its units."""
    off, scale, lg = params

    def value(code):
        v = code * scale + off
        return float(np.exp(v) if lg else v)

    return (f"variable {name!r}: a chunk spans {value(codes[0]):.6g}..{value(codes[1]):.6g}, "
            f"outside its int16 pack range {value(0):.6g}..{value(65534):.6g} (stale "
            "pack_min/pack_max?); int16 packed streaming would clip it. Stream it raw, or "
            "recompute the range (drop the attributes and the Cutout's pack cache)")


class Cutout:
    """Weather-data cutout on one device.

    ``Cutout(path)`` reopens the ``.atc`` store at ``path`` (the suffix is
    added unless it is ``.nc``), its arrays memory-mapped, or reads the
    NetCDF cutout at a ``.nc`` path into memory; ``Cutout(path,
    module=..., x=..., y=..., time=...)`` on a new path makes a cutout that
    ``prepare`` writes there.  Without a path: ``Cutout(module=..., x=..., y=...,
    time=..., dx=..., dy=...)`` (or ``bounds=(x1, y1, x2, y2)``) makes an
    in-memory cutout; ``Cutout(data=..., grid_desc=...)`` wraps prepared
    arrays.  ``device`` defaults to the current CUDA card and raises
    without one; pass ``device="cpu"`` for the plain path on the CPU.
    """

    def __init__(self, path=None, device=None, **cutoutparams):
        if path is not None:
            path = Path(path)
            if path.suffix != ".nc":
                path = path.with_suffix(".atc")
        self.device = resolve_device(device)
        self.dtype = np.dtype(cutoutparams.pop("dtype", "float32"))
        if self.dtype not in _TORCH_DTYPE:
            raise TypeError(f"cutout dtype must be float32 or float64, not {self.dtype}")
        data = cutoutparams.pop("data", None)
        self._lock = threading.RLock()  # builds the fields mapping and stages into it
        self._invalidate()
        self._static_device = None  # a time slice's: its parent's static fields
        self._pack16 = None
        self._ring = None  # the streamer's pinned buffers
        self._copy_stream = None  # and its side stream
        self._mesh = None  # set by shard()

        if path is not None and path.exists():
            if path.suffix == ".nc":
                grid_kwargs, stored, attrs, var_attrs = _read_netcdf_cutout(path)
            else:
                grid_kwargs, stored, attrs, var_attrs = read_store(path)
            self.grid_desc = Grid(**grid_kwargs)
            self.data = dict(stored)
            self.attrs = dict(attrs)
            self.var_attrs = dict(var_attrs)
            if cutoutparams:
                warnings.warn(f"Arguments {', '.join(cutoutparams)} are ignored, since cutout "
                              "is already built.")
        elif data is not None:
            grid_desc = cutoutparams.pop("grid_desc", None)
            if grid_desc is None:
                raise TypeError("data= requires grid_desc=")
            self.grid_desc = grid_desc
            self.data = dict(data)
            self.attrs = cutoutparams.pop("attrs", {})
            self.var_attrs = cutoutparams.pop("var_attrs", {})
        else:
            try:
                x = cutoutparams.pop("x", None)
                y = cutoutparams.pop("y", None)
                if "bounds" in cutoutparams:
                    x1, y1, x2, y2 = cutoutparams.pop("bounds")
                    x, y = slice(x1, x2), slice(y1, y2)
                time = cutoutparams.pop("time")
                module = cutoutparams.pop("module")
                if x is None or y is None:
                    raise KeyError("x/y")
            except KeyError as exc:
                raise TypeError(
                    "Arguments 'time' and 'module' must be specified. "
                    "Spatial bounds must either be passed via argument "
                    "'bounds' or 'x' and 'y'.") from exc
            dx = cutoutparams.pop("dx", 0.25)
            dy = cutoutparams.pop("dy", 0.25)
            dt = cutoutparams.pop("dt", "h")
            xs, ys, times = coordinate_range(x, y, time, dx, dy, dt)
            self.grid_desc = Grid(x=xs, y=ys, time=times, crs=4326)
            self.data = {}
            self.var_attrs = {}
            self.attrs = {"module": module, "prepared_features": [],
                          "dx": dx, "dy": dy, "dt": dt, **cutoutparams}
        self.path = path

        modules = np.atleast_1d(self.attrs.get("module"))
        unknown = [m for m in modules if m not in datamodules]
        if unknown:
            raise ValueError(f"unknown dataset module(s) {unknown}; available: "
                             f"{sorted(datamodules)}")

    # ------------------------------------------------------------------ meta
    @property
    def name(self):
        return self.path.stem if self.path else "<memory>"

    @property
    def module(self):
        return self.attrs.get("module")

    @property
    def crs(self):
        """The CRS of the grid: its dataset module's (4326 for synthetic)."""
        return datamodules[np.atleast_1d(self.module)[0]].crs

    @property
    def coords(self):
        """{"x", "y", "time"} as numpy arrays (stamps as datetime64[ns])."""
        g = self.grid_desc
        return {"x": g.x, "y": g.y, "time": g.time_index}

    @property
    def shape(self):
        return self.grid_desc.shape

    @property
    def extent(self):
        return self.grid_desc.extent

    @property
    def bounds(self):
        return self.grid_desc.bounds

    @property
    def transform(self):
        return self.grid_desc.transform

    @property
    def transform_r(self):
        return self.grid_desc.transform_r

    @property
    def dx(self):
        return self.grid_desc.dx

    @property
    def dy(self):
        return self.grid_desc.dy

    @property
    def dt(self):
        return self.grid_desc.dt

    @property
    def torch_dtype(self):
        return _TORCH_DTYPE[self.dtype]

    @property
    def chunks(self):
        """Stored chunk sizes: attrs named ``chunksize_<dim>``; the time
        entry is the ``time_chunk`` default of convert_and_aggregate."""
        chunks = {k[len("chunksize_"):]: v for k, v in self.attrs.items()
                  if k.startswith("chunksize_")}
        return chunks or None

    @property
    def available_features(self):
        """Table of the variables of each (module, feature) the cutout's
        module(s) can prepare (the JAX package's Series)."""
        rows = [((m, feature), v) for m in np.atleast_1d(self.module)
                for feature, variables in datamodules[m].features.items() for v in variables]
        return Table({"variable": [v for _, v in rows]}, index=[k for k, _ in rows],
                     index_names=("module", "feature"), series=True)

    @property
    def prepared_features(self):
        """Table of the prepared variables by (module, feature)."""
        index = [(self.var_attrs.get(v, {}).get("module"), self.var_attrs.get(v, {}).get("feature"))
                 for v in self.data]
        return Table({"variable": list(self.data)}, index=index,
                     index_names=("module", "feature"), series=True)

    @property
    def prepared(self):
        avail, prep = self.available_features, self.prepared_features
        return set(avail.index) <= set(prep.index) and set(avail.values) <= set(prep.values)

    def _invalidate(self):
        self._fields_cache = None
        self._static_cache = None
        self._pack_cache = None
        self._shard_cache = None

    # ---------------------------------------------------------- preparation
    def prepare(self, features=None, tmpdir=None, data_format=None, overwrite=False,
                compression=None, show_progress=False, dask_kwargs=None,
                monthly_requests=False, concurrent_requests=False, **params):
        """Generate the missing features from the cutout's dataset
        module(s); floating variables are stored in the cutout's dtype with
        their range (``pack_min``/``pack_max``) for packing.  A cutout with
        an ``.atc`` path checkpoints each feature into its store
        (``update_store``: that feature's files and the manifest); one with
        a ``.nc`` path is written whole once, after the last feature.  An
        already prepared cutout returns at once.  ``compression`` is the
        NetCDF encoding (default zlib level 9 with shuffle) and
        ``dask_kwargs``/``show_progress`` go to nothing; the rest go to the
        dataset module."""
        del dask_kwargs, show_progress
        if data_format is not None:
            params.setdefault("data_format", data_format)
        if compression is None:
            compression = {"zlib": True, "complevel": 9, "shuffle": True}
        self._nc_compression = compression
        params.setdefault("monthly_requests", monthly_requests)
        params.setdefault("concurrent_requests", concurrent_requests)
        if tmpdir is None:
            # a scratch directory for the modules' downloads, removed after
            tmpdir = tempfile.mkdtemp(prefix="atlite_tpu_torch_prepare")
            try:
                return self.prepare(features=features, tmpdir=tmpdir, overwrite=overwrite,
                                    compression=compression, **params)
            finally:
                shutil.rmtree(tmpdir, ignore_errors=True)
        if self.prepared and not overwrite:
            logger.info("Cutout already prepared.")
            return self
        features = set(np.atleast_1d(features)) if features is not None else None
        prepared = set(self.prepared_features.index)
        written = set()  # module-priority guard under overwrite
        wrote_any = False
        for module in np.atleast_1d(self.module):
            mod = datamodules[module]
            target = set(mod.features) if features is None else features & set(mod.features)
            for feature in sorted(target):
                if (module, feature) in prepared and not overwrite:
                    continue
                missing = [v for v in mod.features[feature]
                           if (v not in self.data or overwrite) and v not in written]
                if not missing:
                    continue
                logger.info(f"Preparing feature '{feature}' from module '{module}'")
                result = mod.get_data(self, feature, tmpdir=tmpdir, **{**self.attrs, **params})
                new_vars = []
                for var, (dims, arr) in result.items():
                    if var not in missing:
                        continue
                    written.add(var)
                    arr = np.asarray(arr)
                    va = {"dims": dims, "module": module, "feature": feature}
                    if np.issubdtype(arr.dtype, np.floating):
                        arr = arr.astype(self.dtype, copy=False)
                        if arr.size:
                            with np.errstate(invalid="ignore"), warnings.catch_warnings():
                                warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN
                                mn, mx = np.nanmin(arr), np.nanmax(arr)
                            if np.isfinite(mn) and np.isfinite(mx):
                                va["pack_min"], va["pack_max"] = float(mn), float(mx)
                    self.data[var] = arr
                    self.var_attrs[var] = va
                    new_vars.append(var)
                pf = set(np.atleast_1d(self.attrs.get("prepared_features", [])))
                self.attrs["prepared_features"] = sorted(pf | {feature})
                self._invalidate()
                wrote_any = True
                if self.path is not None and self.path.suffix != ".nc":
                    self.to_file(update_vars=new_vars)
        if self.path is not None and self.path.suffix == ".nc" and wrote_any:
            self.to_file()
        return self

    def to_file(self, fn=None, update_vars=None):
        """Write the cutout to its ``.atc`` store (or to ``fn``, as given),
        or to a NetCDF file where the path ends in ``.nc``.  With
        ``update_vars`` only those variables and the manifest of a store are
        written (``update_store``); a ``.nc`` file is rewritten whole."""
        fn = self.path if fn is None else Path(fn)
        if fn is None:
            raise ValueError("cutout has no path; pass fn=")
        if fn.suffix == ".nc":
            self.to_netcdf(fn)
        elif update_vars is not None:
            update_store(fn, self.grid_desc, self.data, self.attrs, self.var_attrs, update_vars)
        else:
            write_store(fn, self.grid_desc, self.data, self.attrs, self.var_attrs)

    def to_netcdf(self, fn, format="NETCDF4", compression=None):
        """Write an atlite-compatible NetCDF cutout.

        The default is atlite's on-disk format: zlib-compressed
        netCDF4/HDF5, ``compression`` the xarray encoding dict (default
        the one ``prepare`` was given, else ``{"zlib": True, "complevel":
        9, "shuffle": True}`` as atlite's data.py:139 applies; ``zlib:
        False`` stores level-0 deflate).  ``format="NETCDF3_64BIT"`` emits
        uncompressed CDF-2, list attrs joined by ", ".  The file is written
        beside ``fn`` and renamed onto it."""
        from atlite_tpu_torch.io.netcdf import write_netcdf

        netcdf4 = format.upper().startswith("NETCDF4")
        if compression is None:
            compression = getattr(self, "_nc_compression", None)
        enc_kwargs = {}
        if netcdf4 and compression:
            if not compression.get("zlib", True):
                enc_kwargs["complevel"] = 0
            else:
                enc_kwargs["complevel"] = int(compression.get("complevel", 4))
            enc_kwargs["shuffle"] = bool(compression.get("shuffle", False))
        g = self.grid_desc
        fn = Path(fn)
        dims = {"time": len(g.time), "y": len(g.y), "x": len(g.x)}
        variables = {
            "x": (("x",), np.asarray(g.x, dtype="float64"), {}),
            "y": (("y",), np.asarray(g.y, dtype="float64"), {}),
            "time": (("time",), np.asarray(g.time), {}),
        }
        for name, arr in self.data.items():
            va = dict(self.var_attrs.get(name, {}))
            dnames = tuple(va.pop("dims", ("time", "y", "x")))
            va = {k: v for k, v in va.items() if isinstance(v, (str, int, float))}
            variables[name] = (dnames, np.asarray(arr), va)
        attrs = {}
        for k, v in self.attrs.items():
            if k in ("prepared_features", "module") and not netcdf4:
                # NetCDF-3 attributes hold no string lists: a merged
                # multi-module cutout's module=['sarah', 'era5'] is joined
                v = ", ".join(np.atleast_1d(v))
            if isinstance(v, (str, int, float, np.integer, np.floating, bool)):
                attrs[k] = v
            elif netcdf4 and isinstance(v, (list, tuple, np.ndarray)):
                attrs[k] = v
        tmp = fn.with_name(fn.name + ".tmp")
        write_netcdf(tmp, dims, variables, attrs=attrs, format=format, **enc_kwargs)
        os.replace(tmp, fn)

    # -------------------------------------------------------------- device
    staged_variables = 0  # tensors that fields() staged on a first read,
    staged_bytes = 0  # and their bytes, (sin, cos) pairs included
    daily_cell_hours = 0  # cell-hours that the degree-day converters folded into days

    def _put(self, arr, dtype):
        """A host array as a tensor on the cutout's device (``_upload``)."""
        return _upload(arr, dtype, self.device)

    def fields(self, dtype=None):
        """Tensors of all prepared variables on the cutout's device, plus
        the (sin, cos) pairs of stored solar angles; built once per dtype.
        A time slice (one that holds its parent's static fields) uploads
        its time fields in one batch; any other cutout returns a
        ``_Fields`` mapping, which stages each variable when a call first
        reads it.
        On a sharded cutout: {name: ShardedTensor} over its mesh, (T, Y, X)
        variables cut on ("t", None, "x"), (Y, X) ones on (None, "x")."""
        dtype = self.dtype if dtype is None else np.dtype(dtype)
        if self._mesh is not None:
            return self._sharded_fields(dtype)
        with self._lock:
            if self._fields_cache is None or self._fields_cache[0] != dtype:
                if self._static_device is not None:
                    batch = self._pack(dtype)
                    dev = None if batch["host"] is None else batch["host"].to(self.device)
                    cache = self._unpack(batch, dev, dtype)
                else:
                    cache = _Fields(self.data, dtype, self.device, len(self.grid_desc.time),
                                    self._lock)
                self._fields_cache = (dtype, cache)
            return self._fields_cache[1]

    def _pack(self, dtype, alloc=None):
        """Host half of a time slice's batched upload.

        The time fields of one shape are stacked into one host tensor from
        ``alloc(shape, torch_dtype)`` (default: a new CPU tensor): raw in
        ``dtype``, or, when every one has pack parameters, as uint16 codes
        ``rint((value - offset) / scale)`` clipped to 0..65534 (NAN_CODE for
        NaN; log of the value in log space), held in an int16 tensor: by
        one native pass over the host's cores (``native.pack16``;
        ``Cutout.packed_native`` counts the fields it packed), else by the
        numpy loop ``_pack_numpy``, the same codes.
        Raises ValueError when a variable's values reach more than half a
        code step beyond its pack range (stale ``pack_min``/``pack_max``):
        clipping them would change the data silently.
        Returns {"host", "names", "params"}; params is None when raw.
        """
        alloc = alloc or (lambda shape, tdt: torch.empty(shape, dtype=tdt))
        static = self._static_device or {}
        batch = [n for n, a in self.data.items() if n not in static and np.ndim(a) == 3]
        if not batch:
            return {"host": None, "names": [], "params": None}
        shape = np.shape(self.data[batch[0]])
        same = [n for n in batch if np.shape(self.data[n]) == shape]
        pack16 = self._pack16
        if pack16 and all(n in pack16 for n in same):
            host = alloc((len(same),) + shape, torch.int16)
            codes = host.numpy().view(np.uint16)
            params = [pack16[n] for n in same]
            sources = [self.data[n] for n in same]
            ranges = native.pack16(sources, params, codes)
            if ranges is None:
                ranges = [_pack_numpy(a, p, c) for a, p, c in zip(sources, params, codes)]
            else:
                Cutout.packed_native += len(same)
            for n, p, (lo, hi) in zip(same, params, ranges):
                if lo < -0.5 or hi > 65534.5:
                    raise ValueError(_out_of_pack_range(n, (lo, hi), p))
            return {"host": host, "names": same, "params": params}
        host = alloc((len(same),) + shape, _TORCH_DTYPE[dtype])
        stack = host.numpy()
        for i, n in enumerate(same):
            stack[i] = self.data[n]
        return {"host": host, "names": same, "params": None}

    def _unpack(self, batch, dev, dtype):
        """Device half of a time slice's batched upload: fields from the
        uploaded stack ``dev`` (codes rebuilt as ``code * scale + offset``,
        NaN at NAN_CODE, ``exp`` in log space), the parent's static
        fields, every other variable on its own, and the solar (sin, cos)
        pairs.  Runs on the current stream."""
        tdt = _TORCH_DTYPE[dtype]
        cache = dict(self._static_device or {})
        for i, n in enumerate(batch["names"]):
            if batch["params"] is None:
                cache[n] = dev[i]
                continue
            off, scale, lg = batch["params"][i]
            # int16 on the card; widen before comparing and scaling
            code = dev[i].to(torch.int32) & 0xFFFF
            sc = torch.tensor(np.asarray(scale, dtype), dtype=tdt, device=dev.device)
            of = torch.tensor(np.asarray(off, dtype), dtype=tdt, device=dev.device)
            v = torch.where(code == NAN_CODE, torch.nan, code.to(tdt) * sc + of)
            cache[n] = torch.exp(v) if lg else v
        for n, a in self.data.items():
            if n not in cache:
                cache[n] = self._put(a, dtype)
        _derive_solar_trig(cache)
        return cache

    def pack_params(self, names):
        """Global CF int16 pack parameters per time variable:
        {name: (offset, scale, log_space)} with ``value ≈ code * scale +
        offset`` (``exp()`` of that in log space), code in 0..65534 and
        NAN_CODE for NaN.  Computed once over the whole stored range, so
        every chunk quantizes alike; positive variables spanning more than
        three decades (roughness) pack in log space."""
        if self._pack_cache is None:
            self._pack_cache = {}
        cache = self._pack_cache
        out = {}
        for n in names:
            if not _time_dims(self.var_attrs, n) or np.ndim(self.data[n]) != 3:
                continue
            if n not in cache:
                va = self.var_attrs.get(n, {})
                if "pack_min" in va and "pack_max" in va:
                    mn, mx = float(va["pack_min"]), float(va["pack_max"])
                else:
                    with np.errstate(invalid="ignore"):
                        mn = float(np.nanmin(self.data[n]))
                        mx = float(np.nanmax(self.data[n]))
                if np.isinf(mn) or np.isinf(mx):
                    raise ValueError(
                        f"variable {n!r} contains non-finite (inf) values; "
                        "int16 packed streaming cannot represent them")
                if np.isnan(mn) or np.isnan(mx):
                    mn, mx = 0.0, 0.0  # all-NaN: any parameters rebuild the NaNs
                use_log = mn > 0.0 and mx / mn > 1e3
                if use_log:
                    mn, mx = float(np.log(mn)), float(np.log(mx))
                scale = (mx - mn) / 65534.0 if mx > mn else 1.0
                cache[n] = (mn, scale, use_log)
            out[n] = cache[n]
        return out

    def isel_time(self, t0, t1, only=None, pack16=None):
        """Time slice [t0, t1) sharing the host arrays (no copy), on the
        same device; its fields stage in one batched upload (packed with
        ``pack16`` from pack_params) and reuse this cutout's staged static
        fields.  ``only`` keeps just the named variables."""
        g = self.grid_desc
        data = {n: (np.asarray(a)[t0:t1] if _time_dims(self.var_attrs, n) else a)
                for n, a in self.data.items() if only is None or n in only}
        sub = Cutout(data=data, grid_desc=dataclasses.replace(g, time=g.time[t0:t1]),
                     attrs=dict(self.attrs), var_attrs=dict(self.var_attrs),
                     dtype=self.dtype, device=self.device)
        sub._static_device = self._stage_static()
        sub._pack16 = pack16
        return sub

    def _stage_static(self):
        """The non-time variables (e.g. height) on the device, staged
        once and shared by every time slice."""
        if self._static_cache is None:
            self._static_cache = {n: self._put(a, self.dtype) for n, a in self.data.items()
                                  if not _time_dims(self.var_attrs, n)}
        return self._static_cache

    _stream_copies = 0  # time slices copied to a card through the side stream
    streamed_bytes = 0  # bytes of the host stacks (codes or raw) the streamer staged
    stream_pack_s = 0.0  # the worker's seconds inside _pack
    packed_native = 0  # time fields of a chunk that _pack packed by the native pass
    stream_wait_s = 0.0  # the caller's seconds waiting for a staged slice

    def _stream_chunks(self, windows, only=None, pack16=None):
        """The streamer's staging: yields the time slice ``isel_time(t0,
        t1, only, pack16)`` of each window (t0, t1, ...) in turn, its fields
        staged and handed to the current stream, while one worker thread
        packs the next.

        On a CUDA card a slice's time fields are packed by the worker into
        a slot of the cutout's ``PinnedRing`` (kept, with the side stream,
        for later streamed calls).  When the caller asks for the slice, its
        copy is issued without blocking on the side stream and unpacked
        there, so its fields are allocated only once the previous slice's
        conversion has returned (a card holds two slices' fields, however
        fast the pack); the current stream waits for that and records its
        use of every tensor the side stream allocated.  On the CPU each
        slice gets fresh host memory.  ``Cutout._stream_copies`` counts the
        slices copied through the side stream, as the kernels count their
        ``launches``; ``Cutout.streamed_bytes`` the bytes of the host stacks
        staged (copied, on a card), ``Cutout.stream_pack_s`` the worker's
        seconds in ``_pack`` and ``Cutout.stream_wait_s`` the seconds the
        caller waited for a slice.  Spans ``pin`` and ``pack <t0>:<t1>``
        run on the worker, ``copy <t0>:<t1>`` on the caller's thread."""
        self._stage_static()  # once, on this thread's stream
        cuda = self.device.type == "cuda"
        if self._ring is None:
            self._ring = PinnedRing(self.device)
        if cuda and self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        ring, stream = self._ring, self._copy_stream

        def pack(t0, t1):  # on the worker
            sub = self.isel_time(t0, t1, only=only, pack16=pack16)

            def alloc(shape, tdt):
                nbytes = int(np.prod(shape)) * tdt.itemsize
                return ring.host(nbytes, t0, t1).view(tdt).view(shape)

            start = perf_counter()
            with span("pack", t0, t1):
                batch = sub._pack(sub.dtype, alloc)
            Cutout.stream_pack_s += perf_counter() - start
            if batch["host"] is not None:
                Cutout.streamed_bytes += batch["host"].numel() * batch["host"].element_size()
            return sub, batch

        def hand_over(t0, t1, sub, batch):  # on the caller's thread
            dtype = sub.dtype
            if batch["host"] is None or not cuda:
                sub._fields_cache = (dtype, sub._unpack(batch, batch["host"], dtype))
                return sub
            with torch.cuda.stream(stream):
                with span("copy", t0, t1):
                    dev = ring.copy(batch["host"], stream)
                Cutout._stream_copies += 1
                sub._fields_cache = (dtype, sub._unpack(batch, dev, dtype))
                ready = torch.cuda.Event()
                ready.record(stream)
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(ready)
            for t in sub._fields_cache[1].values():
                if t.is_cuda:
                    t.record_stream(compute)
            return sub

        with ThreadPoolExecutor(max_workers=1) as worker:
            fut = worker.submit(pack, *windows[0][:2])
            for k in range(len(windows)):
                start = perf_counter()
                sub, batch = fut.result()
                Cutout.stream_wait_s += perf_counter() - start
                # the previous slice's conversion has returned: its
                # temporaries are freed before this slice's fields exist
                sub = hand_over(*windows[k][:2], sub, batch)
                if k + 1 < len(windows):
                    fut = worker.submit(pack, *windows[k + 1][:2])
                yield sub

    # ------------------------------------------------------------------ mesh
    def shard(self, mesh=None):
        """Distribute the cutout over a ("t", "x") device mesh
        (``core.mesh.make_mesh``; None builds one over every local card).

        Each mesh position gets a sub-cutout: a time slice and an x slice
        of the host arrays (no copy) on that position's device, its time
        fields staged in one upload and its static fields once a device
        and x slice; an axis that does not divide the mesh stays whole.
        Converters then run block by block (``convert_and_aggregate``).
        The mesh must be this process's: a mesh that spans processes reads
        a store through ``core.comm.from_store``."""
        from atlite_tpu_torch.core.mesh import Mesh, make_mesh

        mesh = make_mesh() if mesh is None else mesh
        if not isinstance(mesh, Mesh):
            raise TypeError(f"shard() takes a core.mesh.Mesh, not {type(mesh).__name__}")
        if mesh.process_count > 1:
            raise ValueError("a cutout shards over this process's devices; a mesh that spans "
                             "processes reads a store through core.comm.from_store")
        self._mesh = mesh
        self._invalidate()
        return self

    def unshard(self):
        """Back to the cutout's own device."""
        self._mesh = None
        self._invalidate()
        return self

    def _x_bounds(self):
        nx, X = self._mesh.shape["x"], len(self.grid_desc.x)
        return list(range(0, X + 1, X // nx)) if nx > 1 and X % nx == 0 else [0, X]

    def _t_bounds(self):
        """The time cut of ``fields()`` and of converters that treat every
        hour on its own: even pieces, or whole where the mesh's t does not
        divide T."""
        nt, T = self._mesh.shape["t"], len(self.grid_desc.time)
        return list(range(0, T + 1, T // nt)) if nt > 1 and T % nt == 0 else [0, T]

    def _shard_cutouts(self, t_bounds=None):
        """{(t piece, x piece): sub-cutout} of a sharded cutout, in mesh
        order: time piece k is [t_bounds[k], t_bounds[k + 1]) (default: the
        cut of ``fields()``) on mesh row k, x piece l the l-th x slice on
        column l.  Built once per cut."""
        mesh = self._mesh
        if mesh is None:
            raise ValueError("the cutout is not sharded; call shard() first")
        t_bounds = tuple(self._t_bounds() if t_bounds is None else t_bounds)
        if len(t_bounds) - 1 > mesh.shape["t"]:
            raise ValueError(f"{len(t_bounds) - 1} time pieces for a mesh of t={mesh.shape['t']}")
        if self._shard_cache is None:
            self._shard_cache = {"subs": {}, "static": {}}
        cache = self._shard_cache
        xb = self._x_bounds()
        if t_bounds not in cache["subs"]:
            subs = {}
            for k in range(len(t_bounds) - 1):
                for m in range(len(xb) - 1):
                    subs[(k, m)] = self._sub(t_bounds[k], t_bounds[k + 1], xb[m], xb[m + 1],
                                             mesh.devices[k, m])
            cache["subs"][t_bounds] = subs
        return cache["subs"][t_bounds]

    def _sub(self, t0, t1, x0, x1, device):
        """Sub-cutout [t0, t1) x [x0, x1) on ``device`` (the host arrays
        sliced, not copied), whose fields stage in one upload beside the
        static fields of its x slice, staged once a device."""
        g = self.grid_desc
        data = {}
        for n, a in self.data.items():
            a = np.asarray(a)
            if _time_dims(self.var_attrs, n):
                a = a[t0:t1]
            if tuple(self.var_attrs.get(n, {}).get("dims", ("x",)))[-1] == "x":
                a = a[..., x0:x1]
            data[n] = a
        sub = Cutout(data=data, grid_desc=dataclasses.replace(g, x=g.x[x0:x1], time=g.time[t0:t1]),
                     attrs=dict(self.attrs), var_attrs=dict(self.var_attrs), dtype=self.dtype,
                     device=device)
        static = self._shard_cache["static"]
        if (device, x0, x1) not in static:
            static[(device, x0, x1)] = {n: sub._put(a, self.dtype) for n, a in sub.data.items()
                                        if not _time_dims(self.var_attrs, n)}
        sub._static_device = static[(device, x0, x1)]
        return sub

    def _sharded_fields(self, dtype):
        from atlite_tpu_torch.core.mesh import P, ShardedTensor, field_spec

        subs = self._shard_cutouts()
        mesh = self._mesh
        nt, nx = (len(b) - 1 for b in (self._t_bounds(), self._x_bounds()))
        per = {ij: subs[(ij[0] if nt > 1 else 0, ij[1] if nx > 1 else 0)].fields(dtype)
               for ij in mesh.positions()}
        out = {}
        for name, t in per[(0, 0)].items():
            # (T, Y, X) time fields and (Y, X) statics
            spec, parts = (field_spec(), (nt, 1, nx)) if t.ndim == 3 else (P(None, "x"), (1, nx))
            blocks = np.empty((mesh.local_shape["t"], mesh.shape["x"]), dtype=object)
            for ij in mesh.positions():
                b, dev = per[ij][name], mesh.devices[ij]
                # a whole axis: the piece of another position, on this device
                blocks[ij] = b if b.device == dev else b.to(dev)
            out[name] = ShardedTensor(mesh, spec, parts, blocks)
        return out

    # ------------------------------------------------------------------ gis
    @property
    def grid(self):
        """Table of the cell centres (x, y) and their box geometries, x
        fastest (the JAX package's DataFrame)."""
        coords = self.grid_desc.cell_coords()
        cells = [box(*b) for b in self.grid_desc.cell_bounds()]
        return Table({"x": coords[:, 0], "y": coords[:, 1], "geometry": cells})

    def indicatormatrix(self, shapes, shapes_crs=4326):
        """(shapes, cells) sparse matrix of the share of each cell that
        each shape covers (``gis.compute_indicatormatrix``)."""
        return compute_indicatormatrix(self.grid_desc, shapes, self.crs, shapes_crs)

    def intersectionmatrix(self, shapes, shapes_crs=4326):
        """(shapes, cells) sparse 0/1 matrix of the cells each shape
        touches (``gis.compute_intersectionmatrix``)."""
        return compute_intersectionmatrix(self.grid_desc, shapes, self.crs, shapes_crs)

    def availabilitymatrix(self, shapes, excluder, nprocesses=None,
                           disable_progressbar=True, shapes_crs=4326,
                           backend="auto", mesh=None):
        """(shape, y, x) DataArray of the eligible share of each cell per
        shape (``gis.compute_availabilitymatrix``): on a cutout on a CUDA
        card the batched device path, on a CPU cutout the host path;
        ``mesh`` splits the shapes of the device path over its devices."""
        return compute_availabilitymatrix(self, shapes, excluder, nprocesses,
                                          disable_progressbar, shapes_crs, backend, mesh)

    def area(self, crs=None):
        """Cell areas as a (y, x) DataArray, in the units of ``crs``
        (default the cutout's): each cell's four corners transformed, then
        the shoelace area of that quadrilateral."""
        crs = self.crs if crs is None else crs
        g = self.grid_desc
        xe = np.concatenate([g.x - g.dx / 2, [g.x[-1] + g.dx / 2]])
        ye = np.concatenate([g.y - g.dy / 2, [g.y[-1] + g.dy / 2]])
        X, Y = np.meshgrid(xe, ye)
        tx, ty = transform_points(X.ravel(), Y.ravel(), self.crs, crs)
        tx, ty = tx.reshape(X.shape), ty.reshape(Y.shape)
        x00, x10, x11, x01 = tx[:-1, :-1], tx[:-1, 1:], tx[1:, 1:], tx[1:, :-1]
        y00, y10, y11, y01 = ty[:-1, :-1], ty[:-1, 1:], ty[1:, 1:], ty[1:, :-1]
        area = 0.5 * np.abs(x00 * y10 - x10 * y00 + x10 * y11 - x11 * y10
                            + x11 * y01 - x01 * y11 + x01 * y00 - x00 * y01)
        return DataArray(area, coords={"y": g.y, "x": g.x}, dims=("y", "x"))

    def uniform_layout(self):
        """A (y, x) layout of one unit of capacity in every cell."""
        g = self.grid_desc
        return DataArray(np.ones(self.shape), coords={"y": g.y, "x": g.x}, dims=("y", "x"))

    def uniform_density_layout(self, capacity_density, crs=None):
        """A (y, x) layout of ``capacity_density`` per unit of area (of
        ``crs``) in every cell."""
        area = self.area(crs)
        return area.copy(area.values * capacity_density)

    def layout_from_capacity_list(self, data, col="Capacity"):
        """A (y, x) layout from a table of plants: columns ``x``, ``y`` and
        ``col`` (a DataFrame or a dict of equal-length columns), each plant's
        capacity added to the cell whose centre lies nearest.  A point
        exactly on the first coordinate stays in the first cell (the
        reference wraps it to the last)."""
        g = self.grid_desc
        px, py = (np.asarray(data[c], dtype=float) for c in ("x", "y"))
        ix = np.clip(np.searchsorted(g.x, px, side="left"), 0, len(g.x) - 1)
        iy = np.clip(np.searchsorted(g.y, py, side="left"), 0, len(g.y) - 1)
        ix = ix - ((ix > 0) & (px - g.x[ix - 1] < g.x[ix] - px))
        iy = iy - ((iy > 0) & (py - g.y[iy - 1] < g.y[iy] - py))
        layout = np.zeros(self.shape)
        np.add.at(layout, (iy, ix), np.asarray(data[col], dtype=float))
        return DataArray(layout, coords={"y": g.y, "x": g.x}, dims=("y", "x"))

    # ------------------------------------------------------- sel/merge/equals
    def sel(self, path=None, bounds=None, buffer=0, **kwargs):
        """Sub-cutout by label slices of x, y and time (or ``bounds``
        widened by ``buffer``), in memory on the same device."""
        if bounds is not None:
            x1, y1, x2, y2 = bounds
            kwargs.update(x=slice(x1 - buffer, x2 + buffer), y=slice(y1 - buffer, y2 + buffer))
        g = self.grid_desc
        new_grid = g.sel(x=kwargs.get("x"), y=kwargs.get("y"), time=kwargs.get("time"))
        xm, ym = np.isin(g.x, new_grid.x), np.isin(g.y, new_grid.y)
        tm = np.isin(g.time, new_grid.time)
        data = {}
        for name, arr in self.data.items():
            dims = tuple(self.var_attrs.get(name, {}).get("dims", ("time", "y", "x")))
            a = np.asarray(arr)
            if dims == ("time", "y", "x"):
                a = a[tm][:, ym][:, :, xm]
            elif dims == ("y", "x"):
                a = a[ym][:, xm]
            data[name] = a
        return Cutout(path, data=data, grid_desc=new_grid, attrs=dict(self.attrs),
                      var_attrs=dict(self.var_attrs), dtype=self.dtype, device=self.device)

    def merge(self, other, path=None, **kwargs):
        """The variables of two cutouts on the same coordinates, this one's
        first; in memory on this cutout's device."""
        if not isinstance(other, Cutout):
            raise TypeError(f"can only merge a Cutout, not {type(other).__name__}")
        g, og = self.grid_desc, other.grid_desc
        if (len(g.x) != len(og.x) or len(g.y) != len(og.y)
                or not np.allclose(g.x, og.x) or not np.allclose(g.y, og.y)
                or len(g.time) != len(og.time) or (g.time != og.time).any()):
            raise ValueError("cannot merge cutouts with different coordinates; use sel() to "
                             "align them first")
        attrs = {**other.attrs, **self.attrs}
        attrs["module"] = list(dict.fromkeys(list(np.atleast_1d(self.module))
                                             + list(np.atleast_1d(other.module))))
        attrs["prepared_features"] = sorted(set(self.attrs.get("prepared_features", []))
                                            | set(other.attrs.get("prepared_features", [])))
        return Cutout(path, data={**other.data, **self.data}, grid_desc=self.grid_desc,
                      attrs=attrs, var_attrs={**other.var_attrs, **self.var_attrs},
                      dtype=self.dtype, device=self.device)

    def equals(self, other):
        """Same variables with equal values (NaN equal to NaN) on the same
        x, y and time."""
        if not isinstance(other, Cutout) or set(self.data) != set(other.data):
            return False
        g, og = self.grid_desc, other.grid_desc
        return (all(np.array_equal(np.asarray(self.data[k]), np.asarray(other.data[k]),
                                   equal_nan=True) for k in self.data)
                and np.array_equal(g.x, og.x) and np.array_equal(g.y, og.y)
                and np.array_equal(g.time, og.time))

    def __repr__(self):
        g = self.grid_desc
        start = np.datetime_as_string(g.time[0], unit="D") if len(g.time) else "?"
        end = np.datetime_as_string(g.time[-1], unit="D") if len(g.time) else "?"
        # plain str, as pandas prints the JAX package's index (not np.str_)
        features = sorted({str(f) if isinstance(f, str) else f
                           for _, f in self.prepared_features.index})
        return (f'<Cutout "{self.name}">\n'
                f" x = {g.x[0]:.2f} ⟷ {g.x[-1]:.2f}, dx = {g.dx:.2f}\n"
                f" y = {g.y[0]:.2f} ⟷ {g.y[-1]:.2f}, dy = {g.dy:.2f}\n"
                f" time = {start} ⟷ {end}, dt = {g.dt}\n"
                f" module = {self.module}\n"
                f" prepared_features = {features}")

    # ------------------------------------------------ conversion bindings
    convert_and_aggregate = convert.convert_and_aggregate
    temperature = convert.temperature
    soil_temperature = convert.soil_temperature
    dewpoint_temperature = convert.dewpoint_temperature
    coefficient_of_performance = convert.coefficient_of_performance
    heat_demand = convert.heat_demand
    cooling_demand = convert.cooling_demand
    solar_thermal = convert.solar_thermal
    wind = convert.wind
    irradiation = convert.irradiation
    pv = convert.pv
    csp = convert.csp
    runoff = convert.runoff
    hydro = convert.hydro
    line_rating = convert.line_rating


def _read_netcdf_cutout(path):
    """Load an atlite-format NetCDF cutout into (grid_kwargs, data, attrs,
    var_attrs), the tuple the ``.atc`` store loader returns.

    Both axes come out ascending (ERA5 ships descending latitude; atlite
    sorts through maybe_swap_spatial_dims, its gis.py:765-779), lon/lat
    names read as x/y, a comma-joined multi-module attr is split, CF
    packed variables are unpacked, and each variable gets the
    module/feature attrs atlite's preparation stamps (data.py:62-67)."""
    from atlite_tpu_torch.io.netcdf import read_netcdf, unpack_cf

    dims, variables, attrs = read_netcdf(path)
    ren = {"lon": "x", "longitude": "x", "lat": "y", "latitude": "y"}
    variables = {ren.get(k, k): (tuple(ren.get(d, d) for d in dn), arr, va)
                 for k, (dn, arr, va) in variables.items()}
    for c in ("x", "y", "time"):
        if c not in variables:
            raise ValueError(f"{path}: NetCDF cutout lacks coordinate {c!r}")
    x = np.asarray(variables.pop("x")[1], dtype=float)
    y = np.asarray(variables.pop("y")[1], dtype=float)
    tvals = variables.pop("time")[1]
    if np.asarray(tvals).dtype.kind != "M":
        raise ValueError(f"{path}: time coordinate is not CF-decodable")
    flip_y = len(y) > 1 and y[0] > y[-1]
    if flip_y:
        y = y[::-1].copy()
    flip_x = len(x) > 1 and x[0] > x[-1]
    if flip_x:
        x = x[::-1].copy()

    attrs = dict(attrs)
    pf = attrs.get("prepared_features", [])
    if isinstance(pf, str):
        pf = [s for s in (t.strip() for t in pf.split(",")) if s]
    attrs["prepared_features"] = list(np.atleast_1d(pf))
    module = attrs.get("module")
    if isinstance(module, str) and "," in module:
        module = [s for s in (t.strip() for t in module.split(",")) if s]
        attrs["module"] = module
    feature_of = {}
    if module is not None:
        for m in np.atleast_1d(module):
            for feat, vars_ in datamodules[m].features.items():
                for v in vars_:
                    feature_of.setdefault(v, (m, feat))

    data, var_attrs = {}, {}
    for name, (dnames, arr, va) in variables.items():
        arr, va = unpack_cf(arr, va)
        arr = np.asarray(arr)
        if "y" in dnames and flip_y:
            arr = np.flip(arr, axis=dnames.index("y")).copy()
        if "x" in dnames and flip_x:
            arr = np.flip(arr, axis=dnames.index("x")).copy()
        va = dict(va)
        mod_feat = feature_of.get(name, (None, None))
        var_attrs[name] = {
            "dims": list(dnames),
            "module": va.pop("module", mod_feat[0]),
            "feature": va.pop("feature", mod_feat[1]),
            **{k: v for k, v in va.items() if isinstance(v, (str, int, float))},
        }
        data[name] = arr
    grid_kwargs = dict(x=x, y=y, time=np.asarray(tvals, dtype="datetime64[ns]"), crs=4326)
    return grid_kwargs, data, attrs, var_attrs


def _upload(arr, dtype, device):
    """A host array as a tensor on ``device``.  A read-only array (a
    reopened store's memory map) is copied into memory of its own on the
    CPU, where a tensor would alias it, and read by the upload alone on a
    card."""
    a = np.asarray(arr)
    if not a.flags.writeable:
        if device.type == "cpu":
            a = np.array(a, dtype=dtype)
        else:
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore", "The given NumPy array is not writable")
                return torch.as_tensor(a, dtype=_TORCH_DTYPE[dtype], device=device)
    return torch.as_tensor(a, dtype=_TORCH_DTYPE[dtype], device=device)


# the (sin, cos) names of each stored solar angle
_TRIG = {"solar_altitude": ("solar_altitude_sin", "solar_altitude_cos"),
         "solar_azimuth": ("solar_azimuth_sin", "solar_azimuth_cos")}


def _sin_cos(angle, t):
    """(sin, cos) of the solar angle named ``angle``.  cos(altitude) is
    sqrt(clip(1 - sin^2, 0)), as in the JAX package: altitude lies in
    [-pi/2, pi/2], so its cosine is not negative."""
    sin = torch.sin(t)
    if angle == "solar_altitude":
        return sin, torch.sqrt(torch.clamp(1.0 - sin**2, min=0.0))
    return sin, torch.cos(t)


def _derive_solar_trig(cache):
    """Add (sin, cos) tensors of the stored solar angles to a fields
    cache; every converter call then reuses them."""
    for angle, (sin, cos) in _TRIG.items():
        if angle in cache and sin not in cache:
            cache[sin], cache[cos] = _sin_cos(angle, cache[angle])


class _Fields(dict):
    """What ``Cutout.fields()`` returns: a dict of the names of every
    prepared variable, and of the (sin, cos) pairs that
    ``_derive_solar_trig`` would add, whose tensors are staged on the
    device when a call first reads them.

    ``in``, ``iter``, ``len`` and ``keys()`` name them all and stage
    nothing.  A first read uploads the variable (``_upload``) or derives
    both tensors of its pair from the staged angle (``_sin_cos``), in a
    ``copy 0:T`` span; a later read is the dict's own lookup.  Reading
    the whole mapping (``items()``, ``values()``, ``copy()``, ``{**f}``)
    stages everything; a tensor written in is kept.  The host arrays are
    those the cutout held when the mapping was built, and the cutout's
    lock keeps two threads from staging one name twice.
    ``Cutout.staged_variables`` and ``Cutout.staged_bytes`` count what is
    staged."""

    def __init__(self, data, dtype, device, T, lock):
        super().__init__()
        self._data, self._dtype, self._device, self._T = dict(data), dtype, device, T
        self._lock = lock
        self._pairs = {n: angle for angle, pair in _TRIG.items()
                       if angle in data and pair[0] not in data for n in pair}
        self._names = dict.fromkeys([*data, *self._pairs])

    def __missing__(self, name):
        if name not in self._names:
            raise KeyError(name)
        with self._lock:
            if not dict.__contains__(self, name):  # else another thread staged it
                self._stage(name)
        return dict.__getitem__(self, name)

    def _stage(self, name):
        angle = self._pairs.get(name)
        with span("copy", 0, self._T):
            if angle is None:
                staged = {name: _upload(self._data[name], self._dtype, self._device)}
            else:
                staged = dict(zip(_TRIG[angle], _sin_cos(angle, self[angle])))
        for n, t in staged.items():
            if n in self._names and not dict.__contains__(self, n):
                dict.__setitem__(self, n, t)
                Cutout.staged_variables += 1
                Cutout.staged_bytes += t.numel() * t.element_size()

    def __contains__(self, name):
        return name in self._names

    def __iter__(self):
        return iter(self._names)

    def __reversed__(self):
        return reversed(self._names)

    def __len__(self):
        return len(self._names)

    def __repr__(self):
        return f"<fields {list(self._names)}, {dict.__len__(self)} staged>"

    def __setitem__(self, name, t):
        self._names[name] = None
        dict.__setitem__(self, name, t)

    def __delitem__(self, name):
        del self._names[name]
        dict.pop(self, name, None)

    def get(self, name, default=None):
        return self[name] if name in self._names else default

    def copy(self):
        return dict(self)

    def clear(self):
        self._names.clear()
        dict.clear(self)

    def __or__(self, other):
        return {**self, **other}

    def __ior__(self, other):
        self.update(other)
        return self

    __eq__ = Mapping.__eq__
    keys, items, values = Mapping.keys, Mapping.items, Mapping.values
    pop, popitem, setdefault, update = (MutableMapping.pop, MutableMapping.popitem,
                                        MutableMapping.setdefault, MutableMapping.update)
