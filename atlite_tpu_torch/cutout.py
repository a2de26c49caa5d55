"""The Cutout: grid, prepared weather fields and converters (counterpart
of ``atlite_tpu/cutout.py``), held in memory.

The fields live on the host as numpy arrays and are mirrored as tensors on
the cutout's device by ``fields()``, where the converters run.  A time
slice made by ``isel_time`` (the streamer's chunk) stages all its time
fields in one batched upload, raw or packed as CF int16 codes
(``pack_params``), and reuses its parent's staged static fields.

The on-disk ``.atc`` store, NetCDF files, ``sel``/``merge`` and the GIS
methods wait for later slices (ROADMAP queue 1, items 8 and 10).
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from atlite_tpu_torch.convert import convert_and_aggregate, pv, wind
from atlite_tpu_torch.core.grid import Grid, coordinate_range
from atlite_tpu_torch.datasets import modules as datamodules
from atlite_tpu_torch.entry import resolve_device

_TORCH_DTYPE = {np.dtype("float32"): torch.float32, np.dtype("float64"): torch.float64}
NAN_CODE = 65535  # the packed NaN sentinel; codes of values run 0..65534


def _time_dims(var_attrs, name):
    dims = tuple(var_attrs.get(name, {}).get("dims", ("time", "y", "x")))
    return bool(dims) and dims[0] == "time"


class Cutout:
    """Weather-data cutout on one device.

    ``Cutout(module=..., x=..., y=..., time=..., dx=..., dy=...)`` (or
    ``bounds=(x1, y1, x2, y2)``) makes a new cutout to ``prepare``;
    ``Cutout(data=..., grid_desc=...)`` wraps prepared arrays.  ``device``
    defaults to the current CUDA card and raises without one; pass
    ``device="cpu"`` for the plain path on the CPU.
    """

    def __init__(self, path=None, device=None, **cutoutparams):
        if path is not None:
            raise NotImplementedError(
                "cutouts on disk (.atc store, NetCDF) are not ported yet "
                "(ROADMAP queue 1, item 10); build one in memory")
        self.device = resolve_device(device)
        self.dtype = np.dtype(cutoutparams.pop("dtype", "float32"))
        if self.dtype not in _TORCH_DTYPE:
            raise TypeError(f"cutout dtype must be float32 or float64, not {self.dtype}")
        data = cutoutparams.pop("data", None)
        self._invalidate()
        self._stage_batched = False
        self._static_device = None
        self._pack16 = None
        self._pinned = None  # the streamer's pinned buffers (convert._Stager)

        if data is not None:
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

        modules = np.atleast_1d(self.attrs.get("module"))
        unknown = [m for m in modules if m not in datamodules]
        if unknown:
            raise ValueError(f"unknown dataset module(s) {unknown}; available: "
                             f"{sorted(datamodules)}")

    # ------------------------------------------------------------------ meta
    @property
    def module(self):
        return self.attrs.get("module")

    @property
    def shape(self):
        return self.grid_desc.shape

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

    def _invalidate(self):
        self._fields_cache = None
        self._static_cache = None
        self._pack_cache = None

    # ---------------------------------------------------------- preparation
    def prepare(self, features=None, overwrite=False, **params):
        """Generate the missing features from the cutout's dataset
        module(s), in memory; floating variables are stored in the cutout's
        dtype with their range (``pack_min``/``pack_max``) for packing."""
        features = set(np.atleast_1d(features)) if features is not None else None
        prepared = {(va.get("module"), va.get("feature")) for va in self.var_attrs.values()}
        written = set()  # module-priority guard under overwrite
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
                result = mod.get_data(self, feature, **{**self.attrs, **params})
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
                pf = set(np.atleast_1d(self.attrs.get("prepared_features", [])))
                self.attrs["prepared_features"] = sorted(pf | {feature})
                self._invalidate()
        return self

    # -------------------------------------------------------------- device
    def _put(self, arr, dtype):
        return torch.as_tensor(np.asarray(arr), dtype=_TORCH_DTYPE[dtype], device=self.device)

    def fields(self, dtype=None):
        """Tensors of all prepared variables on the cutout's device, plus
        the (sin, cos) pairs of stored solar angles; built once per dtype."""
        dtype = self.dtype if dtype is None else np.dtype(dtype)
        if self._fields_cache is None or self._fields_cache[0] != dtype:
            if self._stage_batched:
                batch = self._pack(dtype)
                dev = None if batch["host"] is None else batch["host"].to(self.device)
                cache = self._unpack(batch, dev, dtype)
            else:
                cache = {n: self._put(a, dtype) for n, a in self.data.items()}
                _derive_solar_trig(cache)
            self._fields_cache = (dtype, cache)
        return self._fields_cache[1]

    def _pack(self, dtype, alloc=None):
        """Host half of a time slice's batched upload.

        The time fields of one shape are stacked into one host tensor from
        ``alloc(shape, torch_dtype)`` (default: a new CPU tensor): raw in
        ``dtype``, or, when every one has pack parameters, as uint16 codes
        ``rint((value - offset) / scale)`` clipped to 0..65534 (NAN_CODE for
        NaN; log of the value in log space), held in an int16 tensor.
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
            for i, n in enumerate(same):
                off, scale, lg = pack16[n]
                a = np.array(self.data[n], dtype=np.float64)
                with np.errstate(invalid="ignore", divide="ignore"):
                    if lg:
                        np.log(a, out=a)
                    np.subtract(a, off, out=a)
                    np.divide(a, scale, out=a)
                    np.rint(a, out=a)
                    np.clip(a, 0.0, 65534.0, out=a)
                a[np.isnan(a)] = NAN_CODE
                codes[i] = a
            return {"host": host, "names": same, "params": [pack16[n] for n in same]}
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
        sub._stage_batched = True
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

    # ------------------------------------------------ conversion bindings
    convert_and_aggregate = convert_and_aggregate
    wind = wind
    pv = pv


def _derive_solar_trig(cache):
    """Add (sin, cos) tensors of the stored solar angles to a fields
    cache; every converter call then reuses them.  cos(altitude) is
    sqrt(clip(1 - sin^2, 0)), as in the JAX package: altitude lies in
    [-pi/2, pi/2], so its cosine is not negative."""
    if "solar_altitude" in cache and "solar_altitude_sin" not in cache:
        sin_alt = torch.sin(cache["solar_altitude"])
        cache["solar_altitude_sin"] = sin_alt
        cache["solar_altitude_cos"] = torch.sqrt(torch.clamp(1.0 - sin_alt**2, min=0.0))
    if "solar_azimuth" in cache and "solar_azimuth_sin" not in cache:
        az = cache["solar_azimuth"]
        cache["solar_azimuth_sin"] = torch.sin(az)
        cache["solar_azimuth_cos"] = torch.cos(az)
