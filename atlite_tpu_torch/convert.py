"""Converters: weather fields -> energy time series (counterpart of
``atlite_tpu/convert.py``): wind, PV, irradiation, solar thermal, CSP, the
temperature family, heat-pump COP, degree-day demand, runoff, the basin-
routed hydro inflow of plants and the dynamic rating of lines.

``convert_and_aggregate`` is the gateway: it composes the spatial
aggregation (``matrix``, ``shapes``, ``layout``), per-unit normalisation and the
temporal aggregation around a converter, resident or streamed over time
chunks.  The streamer (``_chunked_convert``) packs chunk k+1 on a worker
thread into one of two pinned host buffers and copies it to the card on a
side stream while chunk k converts; the aggregation runs inside each chunk,
so only the (bus, T_chunk) series stay behind on the card.  Each streamed
step runs in a ``torch.profiler.record_function`` range named
``"<step> <t0>:<t1>"`` (pin, pack, copy, convert, aggregate), which a
profiler reads per chunk and which costs next to nothing without one.
"""

from __future__ import annotations

import logging
import re
import time
import warnings
from collections.abc import Mapping
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import torch
from torch.profiler import record_function

from atlite_tpu_torch.aggregate import aggregate_matrix, spdiag, spmm_closure
from atlite_tpu_torch.core import timeutil
from atlite_tpu_torch.dataarray import DataArray
from atlite_tpu_torch.entry import resolve_device
from atlite_tpu_torch.gis.geometry import parse_geometry
from atlite_tpu_torch.gis.matrix import _is_series
from atlite_tpu_torch.physics import csp as csp_physics
from atlite_tpu_torch.physics import hydro as hydro_physics
from atlite_tpu_torch.physics import irradiation as irradiation_physics
from atlite_tpu_torch.physics import line_rating as line_rating_physics
from atlite_tpu_torch.physics import orientation, solar, thermal
from atlite_tpu_torch.physics import pv as pv_physics
from atlite_tpu_torch.physics import wind as wind_physics
from atlite_tpu_torch.resource import (
    get_cspinstallationconfig,
    get_solarpanelconfig,
    get_windturbineconfig,
    windturbine_smooth,
)

logger = logging.getLogger(__name__)


def maybe_progressbar(result, show_progress=False, **kwargs):
    """Bring a result to the host; with ``show_progress``, log the time
    that took (atlite shows a dask progress bar here)."""
    del kwargs
    if not show_progress:
        return result.load() if hasattr(result, "load") else result
    t0 = time.perf_counter()
    out = result.load() if hasattr(result, "load") else result
    logger.info("computed %s in %.2fs", getattr(result, "name", None) or "result",
                time.perf_counter() - t0)
    return out


def _tyx(cutout, values, name=None, attrs=None):
    g = cutout.grid_desc
    return DataArray(values, coords={"time": g.time_index, "y": g.y, "x": g.x},
                     dims=("time", "y", "x"), attrs=attrs, name=name)


def _aggregate_time_da(da, method):
    if method == "sum":
        return da.sum("time", keep_attrs=True)
    if method == "mean":
        return da.mean("time", keep_attrs=True)
    return da


# ---------------------------------------------------------------------------
# gateway
# ---------------------------------------------------------------------------
def convert_and_aggregate(cutout, convert_func, matrix=None, index=None, layout=None,
                          shapes=None, shapes_crs=4326, per_unit=False, return_capacity=False,
                          aggregate_time="legacy", capacity_factor=False,
                          capacity_factor_timeseries=False, show_progress=False,
                          dask_kwargs=None, **convert_kwds):
    """Convert, then aggregate in space and time.

    Returns a DataArray (bus, time) with ``matrix``, ``shapes`` or
    ``layout``, else (time, y, x); values on the host.  ``shapes`` (in
    ``shapes_crs``) aggregate by their indicator matrix, labelled by their
    own ``.index`` when they have one; a ``layout`` weights the cells of
    either.  ``capacity_factor`` and ``capacity_factor_timeseries`` are
    the deprecated spellings of ``aggregate_time="mean"`` and ``None``;
    ``dask_kwargs`` is accepted and unused (nothing runs on dask).
    ``time_chunk`` streams the conversion over chunks of that many hours,
    and ``stream_pack="int16"`` packs each chunk's upload (see
    ``Cutout.pack_params``).
    """
    del dask_kwargs
    if aggregate_time not in ("sum", "mean", "legacy", None):
        raise ValueError(f"aggregate_time must be 'sum', 'mean', 'legacy', or None, "
                         f"got {aggregate_time!r}")
    if aggregate_time == "legacy":
        warnings.warn("aggregate_time='legacy' is deprecated and will be removed in a "
                      "future release. Pass 'sum', 'mean', or None explicitly.",
                      FutureWarning, stacklevel=2)
    if capacity_factor or capacity_factor_timeseries:
        if aggregate_time != "legacy":
            raise ValueError("Cannot use 'aggregate_time' together with deprecated "
                             "'capacity_factor' or 'capacity_factor_timeseries'.")
        if capacity_factor:
            warnings.warn("capacity_factor is deprecated. Use aggregate_time='mean' instead.",
                          FutureWarning, stacklevel=2)
            aggregate_time = "mean"
        if capacity_factor_timeseries:
            warnings.warn("capacity_factor_timeseries is deprecated. "
                          "Use aggregate_time=None instead.", FutureWarning, stacklevel=2)
            aggregate_time = None

    time_chunk = convert_kwds.pop("time_chunk", None)
    stream_pack = convert_kwds.pop("stream_pack", None)
    if stream_pack not in (None, "int16"):
        raise ValueError(f"stream_pack must be 'int16' or None, got {stream_pack!r}")
    sharded = getattr(cutout, "_mesh", None) is not None
    if sharded:
        # streamed chunk staging is single-device; on a shard()-ed cutout
        # it would silently drop the mesh decomposition
        if time_chunk:
            raise ValueError(
                "streamed conversion (time_chunk) is single-device and "
                "cannot honor a shard()-ed cutout's mesh; unshard() first, "
                "or use core.comm.from_store for multi-host streaming")
        time_chunk = None  # ignore a stored chunksize: run sharded resident
    elif time_chunk is None:
        # a stored chunk size is the streaming default
        time_chunk = (cutout.chunks or {}).get("time")
        if time_chunk and time_chunk >= len(cutout.grid_desc.time):
            time_chunk = None
    if stream_pack is not None and not time_chunk:
        raise ValueError(
            "stream_pack requires streamed conversion: pass a time_chunk= "
            "smaller than the time axis (sharded cutouts must unshard() "
            "first)")

    if matrix is None and layout is None and shapes is None:
        if per_unit or return_capacity:
            raise ValueError("One of `matrix`, `shapes` and `layout` must be "
                             "given for `per_unit` or `return_capacity`")
        if sharded:
            da = _sharded_convert(cutout, convert_func, **convert_kwds)
        elif time_chunk:
            da = _chunked_convert(cutout, convert_func, time_chunk, stream_pack=stream_pack,
                                  **convert_kwds)
        else:
            da = convert_func(cutout, **convert_kwds)
        agg = "sum" if aggregate_time == "legacy" else aggregate_time
        return maybe_progressbar(_aggregate_time_da(da, agg), show_progress)

    # the matrix is composed before converting: the streamer aggregates
    # inside each chunk
    if matrix is not None:
        if shapes is not None:
            raise ValueError("Passing matrix and shapes is ambiguous. Pass only one of them.")
        if isinstance(matrix, DataArray):
            if index is None and matrix.dims[0] in matrix.coords:
                index = matrix.coords[matrix.dims[0]]
            matrix = matrix.to_numpy()
        if np.ndim(matrix) != 2:
            raise ValueError("Matrix not 2-dimensional.")
        ncells = len(cutout.grid_desc.y) * len(cutout.grid_desc.x)
        if np.shape(matrix)[1] != ncells:
            raise ValueError(f"Matrix spatial dimension ({np.shape(matrix)[1]} columns) "
                             f"not aligned with the cutout grid ({ncells} cells)")
        matrix = sp.csr_matrix(matrix)
    if shapes is not None:
        if _is_series(shapes) and index is None:
            index = shapes.index
        matrix = sp.csr_matrix(cutout.indicatormatrix(shapes, shapes_crs))
    if layout is not None:
        lv = _align_layout(layout, cutout)
        matrix = sp.csr_matrix(lv[None, :]) if matrix is None else matrix @ spdiag(lv)

    bus_name = getattr(index, "name", None) or "bus"
    index = np.arange(matrix.shape[0]) if index is None else np.asarray(index)
    if index.ndim != 1:
        raise ValueError("index must have a single dimension")

    if sharded:
        results = _sharded_convert(cutout, convert_func, aggregate=(matrix, index, bus_name),
                                   **convert_kwds)
    elif time_chunk:
        results = _chunked_convert(cutout, convert_func, time_chunk,
                                   aggregate=(matrix, index, bus_name),
                                   stream_pack=stream_pack, **convert_kwds)
    else:
        da = convert_func(cutout, **convert_kwds)
        results = aggregate_matrix(da, matrix=matrix, index=index, index_name=bus_name)

    capacity = None
    if per_unit or return_capacity:
        caps = np.asarray(matrix.sum(axis=-1)).ravel()
        capacity = DataArray(caps, coords={results.dims[0]: index},
                             dims=(results.dims[0],), attrs={"units": "MW"})
    if per_unit:
        caps = capacity.values
        scale = np.where(caps != 0, 1.0 / np.where(caps != 0, caps, 1.0), 0.0)
        # NaN hours and zero-capacity buses come back as 0.0 (reference fillna(0))
        scaled = results.values * scale[:, None]
        results = results.copy(np.where(np.isnan(scaled), 0.0, scaled))
        results.attrs["units"] = "p.u."
    else:
        results.attrs["units"] = "MW"

    if aggregate_time != "legacy":
        results = _aggregate_time_da(results, aggregate_time)
    results = maybe_progressbar(results, show_progress)
    if return_capacity:
        return results, capacity
    return results


def _align_layout(layout, cutout):
    """Flatten a capacity layout onto the cutout's (y, x) cell order: a
    DataArray with y/x coords is aligned by label (missing cells -> 0), a
    plain array must already be (y, x) in ascending order."""
    g = cutout.grid_desc
    if isinstance(layout, DataArray) and {"y", "x"} <= set(layout.coords):
        if len(layout.dims) != 2:
            raise ValueError("layout must be 2-dimensional (y, x)")
        vals = np.transpose(layout.to_numpy(), [layout.dims.index("y"), layout.dims.index("x")])

        def indexer(labels, targets):
            pos = {v: i for i, v in enumerate(labels.tolist())}
            return np.array([pos.get(t, -1) for t in targets.tolist()], dtype=np.int64)

        iy = indexer(layout.coords["y"], g.y)
        ix = indexer(layout.coords["x"], g.x)
        out = np.zeros(cutout.shape, dtype=float)
        oky, okx = iy >= 0, ix >= 0
        out[np.ix_(oky, okx)] = vals[np.ix_(iy[oky], ix[okx])]
        return out.ravel()
    lv = np.asarray(layout)
    if lv.shape != cutout.shape:
        raise ValueError(f"layout shape {lv.shape} does not match the cutout grid "
                         f"{cutout.shape}; pass a DataArray with y/x coords to align")
    return lv.ravel()


# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------
def _streaming_vars(cutout, convert_func, convert_kwds):
    """The variables a converter reads, so that a streamed chunk moves
    only those; None (stage everything) for converters without an entry."""
    have = set(cutout.data)
    if convert_func is convert_wind:
        fast = f"wnd{int(float(convert_kwds['turbine']['hub_height']))}m"
        if fast in have:
            return {fast}
        # extrapolation picks the closest stored height: keep every
        # wnd<h>m plus the method's auxiliary field
        speeds = {v for v in have if re.fullmatch(r"wnd\d+m", v)}
        method = convert_kwds.get("interpolation_method", "logarithmic")
        return speeds | ({"roughness"} if method == "logarithmic" else {"wnd_shear_exp"})
    solar_vars = {"solar_altitude", "solar_azimuth"} & have
    influx = ({"influx"} if "influx" in have else
              {"influx_direct", "influx_diffuse"}) | {"influx_toa"}
    albedo = {"albedo"} if "albedo" in have else {"outflux"} & have
    # humidity feeds the enhanced clearsky split of an "influx" cutout
    humidity = {"humidity"} & have
    if convert_func in (convert_pv, convert_solar_thermal):
        return influx | albedo | solar_vars | humidity | {"temperature"}
    if convert_func is convert_irradiation:
        return influx | albedo | solar_vars | humidity | ({"temperature"} & have)
    if convert_func is convert_csp:
        return ({"influx_direct"} & have) | solar_vars
    if convert_func in (convert_temperature, convert_heat_demand, convert_cooling_demand):
        return {"temperature"}
    if convert_func is convert_soil_temperature:
        return {"soil temperature"}
    if convert_func is convert_dewpoint_temperature:
        return {"dewpoint temperature"}
    if convert_func is convert_coefficient_of_performance:
        air = convert_kwds.get("source", "air") == "air"
        return {"temperature" if air else "soil temperature"}
    if convert_func is convert_runoff:
        return {"runoff"} | ({"height"} if convert_kwds.get("weight_with_height", True) else set())
    return None


def _chunk_bounds(cutout, convert_func, time_chunk, convert_kwds):
    """[t0, t1, ...] chunk boundaries along the hour axis: every
    ``time_chunk`` hours, or, for converters marked ``_day_aligned``, at
    the first day edge (after ``hour_shift``) at least ``time_chunk``
    hours on, so that no day is split between chunks."""
    T = len(cutout.grid_desc.time)
    if not getattr(convert_func, "_day_aligned", False):
        return list(range(0, T, time_chunk)) + [T]
    _, ids = timeutil.daily_groups(cutout.grid_desc.time, convert_kwds.get("hour_shift", 0.0))
    starts = np.flatnonzero(np.r_[True, np.diff(ids) != 0])
    bounds = [0]
    for s in starts[1:]:
        if int(s) - bounds[-1] >= time_chunk:
            bounds.append(int(s))
    bounds.append(T)
    return bounds


def _stream_windows(cutout, convert_func, time_chunk, convert_kwds):
    """The streamer's chunks, [(t0, t1, drop), ...]: ``_chunk_bounds``, and
    for converters marked ``_time_elementwise`` a short last window slid
    back to a whole chunk whose first ``drop`` hours are dropped."""
    bounds = _chunk_bounds(cutout, convert_func, time_chunk, convert_kwds)
    T = bounds[-1]
    windows = [(bounds[i], bounds[i + 1], 0) for i in range(len(bounds) - 1)]
    if getattr(convert_func, "_time_elementwise", False) and len(windows) > 1:
        t0_l, t1_l, _ = windows[-1]
        if t1_l - t0_l < time_chunk and T >= time_chunk:
            windows[-1] = (T - time_chunk, T, time_chunk - (t1_l - t0_l))
    return windows


class _Stager:
    """Stages time chunks of a cutout on its device.

    On a CUDA card each chunk is packed into one of two pinned host
    buffers, copied with ``non_blocking=True`` on a side stream and
    unpacked there; ``ready`` marks the end.  The buffers, the events of
    their last copies and the side stream are kept on the cutout
    (``Cutout._pinned``), so later streamed calls reuse them.  A buffer is
    refilled only after the event of its last copy has completed, and the
    compute stream waits on ``ready`` and records its use of every tensor
    the side stream allocated (``use``).  On the CPU each chunk gets fresh
    host memory.  ``copies`` counts the chunks copied to the card through
    the side stream, as the kernels count their ``launches``.
    """

    copies = 0

    def __init__(self, cutout, only, pack16):
        self.cutout, self.only, self.pack16 = cutout, only, pack16
        self.cuda = cutout.device.type == "cuda"
        self.n = 0
        if self.cuda and cutout._pinned is None:
            cutout._pinned = {"stream": torch.cuda.Stream(cutout.device),
                              "buffers": [None, None], "copied": [None, None]}

    def stage(self, t0, t1):
        """Chunk [t0, t1) with its fields staged; runs on the worker."""
        sub = self.cutout.isel_time(t0, t1, only=self.only, pack16=self.pack16)
        dtype = sub.dtype
        i, self.n = self.n % 2, self.n + 1
        pinned = self.cutout._pinned

        def alloc(shape, tdt):
            if not self.cuda:
                return torch.empty(shape, dtype=tdt)
            buffers, copied = pinned["buffers"], pinned["copied"]
            nbytes = int(np.prod(shape)) * torch.empty((), dtype=tdt).element_size()
            if copied[i] is not None:
                copied[i].synchronize()  # the buffer's last copy is done
            if buffers[i] is None or buffers[i].numel() < nbytes:
                # a pinned allocation stalls the card: size both buffers
                # together, before any chunk of this call computes
                with record_function(f"pin {t0}:{t1}"):
                    for j in (0, 1):
                        if copied[j] is not None:
                            copied[j].synchronize()
                        if buffers[j] is None or buffers[j].numel() < nbytes:
                            buffers[j] = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            return buffers[i][:nbytes].view(tdt).view(shape)

        with record_function(f"pack {t0}:{t1}"):
            batch = sub._pack(dtype, alloc)
        if batch["host"] is None or not self.cuda:
            sub._fields_cache = (dtype, sub._unpack(batch, batch["host"], dtype))
            return sub, None
        stream = pinned["stream"]
        with torch.cuda.stream(stream):
            with record_function(f"copy {t0}:{t1}"):
                dev = batch["host"].to(self.cutout.device, non_blocking=True)
            _Stager.copies += 1
            pinned["copied"][i] = torch.cuda.Event()
            pinned["copied"][i].record(stream)
            sub._fields_cache = (dtype, sub._unpack(batch, dev, dtype))
            ready = torch.cuda.Event()
            ready.record(stream)
        return sub, ready

    @staticmethod
    def use(sub, ready):
        """Hand a staged chunk to the current (compute) stream."""
        if ready is None:
            return
        compute = torch.cuda.current_stream(sub.device)
        compute.wait_event(ready)
        for t in sub._fields_cache[1].values():
            if t.is_cuda:
                t.record_stream(compute)


def _chunked_convert(cutout, convert_func, time_chunk, aggregate=None, stream_pack=None,
                     **convert_kwds):
    """Stream the conversion over time chunks (see the module docstring).

    With ``aggregate=(csr_matrix, index, bus_name)`` each chunk is
    aggregated on the device right after its conversion.  Converters
    marked ``_time_elementwise`` slide a short last window back to a full
    chunk and drop the overlap, so every chunk has one shape; the
    ``_day_aligned`` demand converters stream whole days in chunks of
    varying length (``_chunk_bounds``) and return one step a day.
    """
    T = len(cutout.grid_desc.time)
    if T == 0 or time_chunk <= 0:
        raise ValueError(f"time_chunk streaming needs a positive chunk and a non-empty "
                         f"time axis (T={T}, time_chunk={time_chunk})")
    needed = _streaming_vars(cutout, convert_func, convert_kwds)
    if needed is not None:
        # statics (e.g. height) are staged once by the parent regardless
        needed = (needed & set(cutout.data)) | {
            n for n in cutout.data
            if tuple(cutout.var_attrs.get(n, {}).get("dims", ("time",)))[0] != "time"}
    pack16 = None
    if stream_pack is not None:
        pack16 = cutout.pack_params(list(needed) if needed is not None else list(cutout.data))

    agg_fn = None
    if aggregate is not None:
        matrix, index, bus_name = aggregate
        agg_fn = spmm_closure(matrix)

    windows = _stream_windows(cutout, convert_func, time_chunk, convert_kwds)
    cutout._stage_static()  # once, on this thread's stream
    stager = _Stager(cutout, needed, pack16)
    pieces, times = [], []
    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(stager.stage, windows[0][0], windows[0][1])
        for i, (t0, t1, drop) in enumerate(windows):
            sub, ready = fut.result()
            if i + 1 < len(windows):
                fut = ex.submit(stager.stage, windows[i + 1][0], windows[i + 1][1])
            _Stager.use(sub, ready)
            with record_function(f"convert {t0}:{t1}"):
                da = convert_func(sub, **convert_kwds)
            tvals = da.coords["time"][drop:]
            if agg_fn is not None:
                with record_function(f"aggregate {t0}:{t1}"):
                    out = agg_fn(da.values.reshape(da.sizes["time"], -1)).T  # (B, Tc)
                pieces.append(out[:, drop:])  # stays on the device
                template = DataArray(out[:, drop:], coords={bus_name: index, "time": tvals},
                                     dims=(bus_name, "time"), attrs=da.attrs, name=da.name)
            else:
                template = DataArray(da.values[drop:], coords={**da.coords, "time": tvals},
                                     dims=da.dims, attrs=da.attrs, name=da.name)
                pieces.append(template.to_numpy())
            times.append(tvals)
    taxis = template.dims.index("time")
    if agg_fn is not None:
        values = torch.cat(pieces, dim=taxis).cpu().numpy()
    else:
        values = np.concatenate(pieces, axis=taxis)
    return DataArray(values, coords={**template.coords, "time": np.concatenate(times)},
                     dims=template.dims, attrs=template.attrs, name=template.name)


# ---------------------------------------------------------------------------
# sharded conversion
# ---------------------------------------------------------------------------
def _sharded_convert(cutout, convert_func, aggregate=None, **convert_kwds):
    """Convert a shard()-ed cutout block by block (``Cutout._shard_cutouts``).

    Time is cut by the streamer's rules: converters marked
    ``_time_elementwise`` (every hour on its own) into the mesh's even t
    pieces; the ``_day_aligned`` demand converters at day edges
    (``_chunk_bounds`` with ceil(T / t) hours a piece), so that no day is
    split; any other converter runs with "t" whole.  Each block converts
    on its device.  With ``aggregate=(csr_matrix, index, bus_name)`` each
    block's series are contracted with its own columns of the matrix, the
    partial (T_l, B) series summed over "x" on the row's first device and
    the rows joined over "t"; without, the gridded blocks are joined over
    "x" and "t".  Returns a DataArray of host values.
    """
    T = len(cutout.grid_desc.time)
    nt = cutout._mesh.shape["t"]
    if getattr(convert_func, "_day_aligned", False):
        bounds = _chunk_bounds(cutout, convert_func, -(-T // nt), convert_kwds)
    elif getattr(convert_func, "_time_elementwise", False):
        bounds = None  # the cut of fields()
    else:
        bounds = [0, T]
    subs = cutout._shard_cutouts(bounds)
    closures = {}
    g = cutout.grid_desc
    Y, X = len(g.y), len(g.x)
    xb = cutout._x_bounds()
    if aggregate is not None:
        matrix, index, bus_name = aggregate
        csc = sp.csc_matrix(matrix)
    rows, times = {}, {}
    for (k, m), sub in subs.items():
        da = convert_func(sub, **convert_kwds)
        times.setdefault(k, da.coords["time"])
        if aggregate is None:
            rows.setdefault(k, []).append(da.to_numpy())
            continue
        if (m, sub.device) not in closures:
            x0, x1 = xb[m], xb[m + 1]
            cols = (np.arange(Y)[:, None] * X + np.arange(x0, x1)[None, :]).ravel()
            closures[(m, sub.device)] = spmm_closure(csc[:, cols].tocsr())
        values = torch.as_tensor(da.values).reshape(da.sizes["time"], -1)
        part = closures[(m, sub.device)](values)  # (T_l, B)
        acc = rows.get(k)
        rows[k] = part if acc is None else acc + part.to(acc.device, non_blocking=True)
    time_coord = np.concatenate([times[k] for k in sorted(times)])
    if aggregate is None:
        values = np.concatenate([np.concatenate(rows[k], axis=-1) for k in sorted(rows)], axis=0)
        return DataArray(values, coords={**da.coords, "time": time_coord, "x": g.x},
                         dims=da.dims, attrs=da.attrs, name=da.name)
    values = np.concatenate([rows[k].T.cpu().numpy() for k in sorted(rows)], axis=1)
    return DataArray(values, coords={bus_name: index, "time": time_coord},
                     dims=(bus_name, "time"), attrs=da.attrs, name=da.name)


# ---------------------------------------------------------------------------
# temperature family
# ---------------------------------------------------------------------------
def convert_temperature(cutout):
    return _tyx(cutout, thermal.temperature_celsius(cutout.fields()))


def temperature(cutout, **params):
    """Ambient temperature [degC]."""
    return cutout.convert_and_aggregate(convert_func=convert_temperature, **params)


def convert_soil_temperature(cutout):
    return _tyx(cutout, thermal.soil_temperature_celsius(cutout.fields()))


def soil_temperature(cutout, **params):
    """Soil temperature [degC], 0 at the sea's NaN cells."""
    return cutout.convert_and_aggregate(convert_func=convert_soil_temperature, **params)


def convert_dewpoint_temperature(cutout):
    return _tyx(cutout, thermal.dewpoint_temperature_celsius(cutout.fields()))


def dewpoint_temperature(cutout, **params):
    """Dewpoint temperature [degC]."""
    return cutout.convert_and_aggregate(convert_func=convert_dewpoint_temperature, **params)


def convert_coefficient_of_performance(cutout, source, sink_T, c0, c1, c2):
    if source not in ("air", "soil"):
        raise NotImplementedError("'source' must be one of ['air', 'soil']")
    fields = cutout.fields()
    if source == "air":
        source_T = thermal.temperature_celsius(fields)
    else:
        source_T = thermal.soil_temperature_celsius(fields)
    d0, d1, d2 = thermal.COP_COEFFS[source]
    c0 = d0 if c0 is None else c0
    c1 = d1 if c1 is None else c1
    c2 = d2 if c2 is None else c2
    return _tyx(cutout, thermal.coefficient_of_performance(source_T, sink_T, c0, c1, c2))


def coefficient_of_performance(cutout, source="air", sink_T=55.0, c0=None, c1=None, c2=None,
                               **params):
    """Heat-pump COP from the ambient (``source="air"``) or soil
    temperature, by the quadratic regressions of ``thermal.COP_COEFFS``."""
    return cutout.convert_and_aggregate(
        convert_func=convert_coefficient_of_performance,
        source=source, sink_T=sink_T, c0=c0, c1=c1, c2=c2, **params)


# ---------------------------------------------------------------------------
# heat / cooling demand: one step a day
# ---------------------------------------------------------------------------
def _daily_demand(cutout, threshold, a, constant, hour_shift, kind):
    fields = cutout.fields()
    days, ids = timeutil.daily_groups(cutout.grid_desc.time, hour_shift)
    daily_T = thermal.daily_mean(fields["temperature"], ids, len(days))
    demand = thermal.degree_day_demand(daily_T, threshold, a, constant, kind)
    g = cutout.grid_desc
    return DataArray(demand, coords={"time": days, "y": g.y, "x": g.x},
                     dims=("time", "y", "x"), name=f"{kind}_demand")


def convert_heat_demand(cutout, threshold, a, constant, hour_shift):
    return _daily_demand(cutout, threshold, a, constant, hour_shift, "heat")


def heat_demand(cutout, threshold=15.0, a=1.0, constant=0.0, hour_shift=0.0, **params):
    """Degree-day heat demand from the daily-mean temperature; days start
    ``hour_shift`` hours before midnight of the stamps' clock."""
    return cutout.convert_and_aggregate(
        convert_func=convert_heat_demand, threshold=threshold, a=a, constant=constant,
        hour_shift=hour_shift, **params)


def convert_cooling_demand(cutout, threshold, a, constant, hour_shift):
    return _daily_demand(cutout, threshold, a, constant, hour_shift, "cooling")


def cooling_demand(cutout, threshold=23.0, a=1.0, constant=0.0, hour_shift=0.0, **params):
    """Degree-day cooling demand from the daily-mean temperature."""
    return cutout.convert_and_aggregate(
        convert_func=convert_cooling_demand, threshold=threshold, a=a, constant=constant,
        hour_shift=hour_shift, **params)


# ---------------------------------------------------------------------------
# solar: irradiation, pv, solar thermal
# ---------------------------------------------------------------------------
def _resolve_solar_position(fields, eph, lon, lat, trig_carry=False):
    """Stored solar angles (with their cached (sin, cos) pairs) when the
    cutout has them, else the position from the ephemeris tables."""
    if "solar_altitude" in fields and "solar_azimuth" in fields:
        sp_ = {"altitude": fields["solar_altitude"], "azimuth": fields["solar_azimuth"]}
        if trig_carry:
            for src, dst in (("solar_altitude_sin", "sin_altitude"),
                             ("solar_altitude_cos", "cos_altitude"),
                             ("solar_azimuth_sin", "sin_azimuth"),
                             ("solar_azimuth_cos", "cos_azimuth")):
                if src in fields:
                    sp_[dst] = fields[src]
        return sp_
    return solar.solar_position(eph["declination"], eph["hour_angle0"], lon, lat)


def _solar_inputs(cutout, fields):
    """(ephemeris tables or None, lon, lat) as tensors on the cutout's
    device; the tables only when the cutout stores no solar angles."""
    g = cutout.grid_desc

    def put(a):
        return torch.as_tensor(np.asarray(a), dtype=cutout.torch_dtype, device=cutout.device)

    eph = None
    if not ("solar_altitude" in fields and "solar_azimuth" in fields):
        eph = {k: put(v) for k, v in timeutil.solar_ephemeris(g.time, "0h").items()}
    return eph, put(g.x), put(g.y)


def _solar_chain(fields, eph, lon, lat, orient, tracking, trigon_model, clearsky_model,
                 altitude_threshold=1.0, irradiation_kind="total", panel=None,
                 solar_thermal_cfg=None):
    """Solar position -> orientation -> transposition [-> panel model |
    -> collector model]."""
    sp_ = _resolve_solar_position(fields, eph, lon, lat, trig_carry=True)
    surf = orientation.surface_orientation(sp_, lat, orient, tracking)
    irr = irradiation_physics.tilted_irradiation(
        fields, sp_, surf, trigon_model=trigon_model, clearsky_model=clearsky_model,
        tracking=tracking, altitude_threshold=altitude_threshold,
        irradiation=irradiation_kind)
    if panel is not None:
        return pv_physics.solar_panel_power(irr, fields["temperature"], panel)
    if solar_thermal_cfg is not None:
        cfg = solar_thermal_cfg
        return thermal.solar_thermal_output(irr, fields["temperature"], cfg["c0"], cfg["c1"],
                                            cfg["t_store"])
    return irr


def _run_solar_chain(cutout, orient, tracking=None, trigon_model="simple",
                     clearsky_model="simple", irradiation_kind="total", panel=None,
                     solar_thermal_cfg=None):
    if not isinstance(orient, dict) or "kind" not in orient:
        orient = orientation.get_orientation(orient)
    fields = cutout.fields()
    eph, lon, lat = _solar_inputs(cutout, fields)
    out = _solar_chain(fields, eph, lon, lat, orient, tracking, trigon_model, clearsky_model,
                       irradiation_kind=irradiation_kind, panel=panel,
                       solar_thermal_cfg=solar_thermal_cfg)
    da = _tyx(cutout, out)
    # irradiation is in W m**-2, pv is 'specific generation' in kWh/kWp,
    # solar thermal stamps nothing
    if panel is not None:
        da.attrs["units"] = "kWh/kWp"
        da.name = "specific generation"
    elif solar_thermal_cfg is None:
        da.attrs["units"] = "W m**-2"
    return da


def convert_irradiation(cutout, orientation, tracking=None, irradiation="total",
                        trigon_model="simple", clearsky_model="simple"):
    return _run_solar_chain(cutout, orientation, tracking, trigon_model, clearsky_model,
                            irradiation_kind=irradiation)


def irradiation(cutout, orientation, irradiation="total", tracking=None, clearsky_model=None,
                trigon_model="simple", **params):
    """Total, direct, diffuse or ground irradiation on a tilted surface."""
    return cutout.convert_and_aggregate(
        convert_func=convert_irradiation, orientation=orientation, tracking=tracking,
        irradiation=irradiation, clearsky_model=clearsky_model, trigon_model=trigon_model,
        **params)


def convert_pv(cutout, panel, orientation, tracking=None, trigon_model="simple",
               clearsky_model="simple"):
    return _run_solar_chain(cutout, orientation, tracking, trigon_model, clearsky_model,
                            panel=panel)


def pv(cutout, panel, orientation, tracking=None, clearsky_model=None,
       trigon_model="simple", **params):
    """Downward radiation + temperature -> PV generation."""
    if isinstance(panel, (str, Path)):
        panel = get_solarpanelconfig(panel)
    return cutout.convert_and_aggregate(
        convert_func=convert_pv, panel=panel, orientation=orientation, tracking=tracking,
        clearsky_model=clearsky_model, trigon_model=trigon_model, **params)


def convert_solar_thermal(cutout, orientation, trigon_model, clearsky_model, c0, c1, t_store):
    return _run_solar_chain(cutout, orientation, None, trigon_model, clearsky_model,
                            solar_thermal_cfg={"c0": c0, "c1": c1, "t_store": t_store})


def solar_thermal(cutout, orientation=None, trigon_model="simple", clearsky_model="simple",
                  c0=0.8, c1=3.0, t_store=80.0, **params):
    """Solar-thermal collector output; the collector faces south at 45
    degrees unless ``orientation`` says otherwise."""
    if orientation is None:
        orientation = {"slope": 45.0, "azimuth": 180.0}
    return cutout.convert_and_aggregate(
        convert_func=convert_solar_thermal, orientation=orientation,
        trigon_model=trigon_model, clearsky_model=clearsky_model, c0=c0, c1=c1,
        t_store=t_store, **params)


# ---------------------------------------------------------------------------
# wind
# ---------------------------------------------------------------------------
def _wind_pipeline(fields, V, POW_norm, to_height, method):
    wnd_hub = wind_physics.extrapolate_wind_speed(fields, to_height, method=method)
    return wind_physics.power_curve(wnd_hub, V, POW_norm, 1.0)


def convert_wind(cutout, turbine, interpolation_method="logarithmic"):
    V, POW, hub_height, P = (turbine[k] for k in ("V", "POW", "hub_height", "P"))
    # exact collinear-knot removal: identical results, fewer segments
    V, POW = wind_physics.simplify_power_curve(V, POW)
    fields = cutout.fields()
    dt = cutout.dtype
    # POW / P rounded once in the cutout dtype, as the JAX package divides
    POWn = np.asarray(POW, dtype=dt) / dt.type(P)
    out = _wind_pipeline(
        fields, torch.as_tensor(np.asarray(V, dtype=dt), device=cutout.device),
        torch.as_tensor(POWn, device=cutout.device), to_height=float(hub_height),
        method=interpolation_method)
    return _tyx(cutout, out, name="specific generation", attrs={"units": "MWh/MWp"})


def wind(cutout, turbine, smooth=False, add_cutout_windspeed=False,
         interpolation_method="logarithmic", **params):
    """Wind generation: hub-height extrapolation + power curve.  ``turbine``
    is a registry name, a Path to a turbine file or a config dict;
    ``smooth`` (True or a dict of ``windturbine_smooth``'s parameters)
    convolves its power curve with a Gaussian first."""
    turbine = get_windturbineconfig(turbine, add_cutout_windspeed=add_cutout_windspeed)
    if smooth:
        turbine = windturbine_smooth(turbine, params=smooth)
    return cutout.convert_and_aggregate(
        convert_func=convert_wind, turbine=turbine,
        interpolation_method=interpolation_method, **params)


# ---------------------------------------------------------------------------
# CSP
# ---------------------------------------------------------------------------
def convert_csp(cutout, installation):
    fields = cutout.fields()
    eph, lon, lat = _solar_inputs(cutout, fields)
    sp_ = _resolve_solar_position(fields, eph, lon, lat)
    out = csp_physics.csp_specific_generation(fields, sp_, installation)
    return _tyx(cutout, out, name="specific generation", attrs={"units": "kWh/kW_ref"})


def csp(cutout, installation, technology=None, **params):
    """CSP generation from direct radiation: ``installation`` by name or
    config; ``technology`` ('parabolic trough' or 'solar tower') overrides
    the installation's."""
    if isinstance(installation, (str, Path)):
        installation = get_cspinstallationconfig(installation)
    if technology is not None:
        installation = dict(installation, technology=technology)
    return cutout.convert_and_aggregate(convert_func=convert_csp, installation=installation,
                                        **params)


# ---------------------------------------------------------------------------
# hydro: runoff, and the basin-routed inflow
# ---------------------------------------------------------------------------
def convert_runoff(cutout, weight_with_height=True):
    fields = cutout.fields()
    runoff_ = fields["runoff"]
    if weight_with_height:
        runoff_ = runoff_ * fields["height"]
    return _tyx(cutout, runoff_)


def _year_of(labels):
    """Integer years of index labels: stamps (datetime64, or objects with
    a ``year``) by their year, anything else as an int."""
    a = np.asarray(labels)
    if a.dtype.kind == "M":
        return a.astype("datetime64[Y]").astype(np.int64) + 1970
    return np.array([int(getattr(v, "year", v)) for v in a.tolist()], dtype=np.int64)


def _yearly_totals(stats):
    """(years, totals, labels) of yearly statistics: a mapping {year:
    total} or {year: {bus: total}}, or a pandas-like Series (``index``,
    ``values``) or DataFrame (also ``columns``).  ``totals`` is (n_years,)
    with ``labels`` None, or (n_years, n_labels)."""
    if isinstance(stats, Mapping):
        years = list(stats)
        rows = [stats[y] for y in years]
        if rows and isinstance(rows[0], Mapping):
            labels = list(rows[0])
            totals = np.array([[row.get(b, np.nan) for b in labels] for row in rows], float)
            return _year_of(years), totals, np.asarray(labels)
        return _year_of(years), np.asarray(rows, dtype=float), None
    totals = np.asarray(stats.values, dtype=float)
    labels = np.asarray(stats.columns) if totals.ndim == 2 else None
    return _year_of(stats.index), totals, labels


def runoff(cutout, smooth=None, lower_threshold_quantile=None, normalize_using_yearly=None,
           **params):
    """Runoff series, optionally smoothed by a trailing mean (``smooth``
    hours; True is a week, False/None/0 none), floored at a quantile
    (values below it set to 0; True is 0.5%), and scaled so that each
    bus's sum over the full years matches ``normalize_using_yearly``."""
    result = cutout.convert_and_aggregate(convert_func=convert_runoff, **params)
    two = isinstance(result, tuple)
    res = result[0] if two else result

    if smooth:
        if smooth is True:
            smooth = 24 * 7
        res = res.rolling_mean("time", smooth, min_periods=1)

    if lower_threshold_quantile is not None:
        if lower_threshold_quantile is True:
            lower_threshold_quantile = 5e-3
        values = res.to_numpy()
        thr = np.nanquantile(values.ravel(), lower_threshold_quantile)
        res = res.copy(np.where(values >= thr, values, 0.0))

    if normalize_using_yearly is not None:
        stat_years, totals, labels = _yearly_totals(normalize_using_yearly)
        uniq, ids = timeutil.yearly_groups(res.coords["time"])
        years, counts = uniq[ids], np.bincount(ids)
        full = np.intersect1d(uniq[counts > 8700], stat_years)
        if not len(full):
            raise ValueError("Need at least a full year of data (more is better)")
        lo, hi = int(full.min()), int(full.max())
        sel = (years >= lo) & (years <= hi)
        target = totals[(stat_years >= lo) & (stat_years <= hi)].sum(axis=0)
        taxis = res.dims.index("time")
        bus_dim = res.dims[1 - taxis]
        if labels is not None:
            # align the per-bus totals to the result's bus labels
            pos = {v: i for i, v in enumerate(labels.tolist())}
            target = np.array([target[pos[b]] if b in pos else np.nan
                               for b in res.coords[bus_dim].tolist()])
        values = res.to_numpy()
        denom = values[:, sel].sum(axis=1) if taxis == 1 else values[sel].sum(axis=0)
        scale = np.asarray(target) / denom
        res = res.copy(values * (scale[:, None] if taxis == 1 else scale[None, :]))

    return (res, result[1]) if two else res


def hydro(cutout, plants, hydrobasins, flowspeed=1, weight_with_height=False,
          show_progress=False, **kwargs):
    """Per-plant inflow [m^3/h] as a (plant, time) DataArray: each basin's
    runoff averaged over its cells (the row-normalised indicator matrix of
    the basins) times its area, then rolled by the travel time to each
    plant downstream and summed.  ``plants``: columns ``lon``, ``lat``;
    ``hydrobasins``: ``HYBAS_ID``, ``NEXT_DOWN``, ``DIST_MAIN`` [km] and
    ``geometry``; each a DataFrame or a dict of columns.  Other keywords go
    to ``runoff``."""
    basins = hydro_physics.determine_basins(plants, hydrobasins, show_progress)
    matrix = sp.csr_matrix(cutout.indicatormatrix(basins.shapes))
    row_sums = np.asarray(matrix.sum(axis=1)).ravel()
    inv = np.where(row_sums != 0, 1.0 / np.where(row_sums != 0, row_sums, 1), 0.0)
    runoff_da = cutout.runoff(matrix=spdiag(inv) @ matrix, index=np.asarray(list(basins.shapes)),
                              weight_with_height=weight_with_height, **kwargs)
    # m of water an hour -> m^3 an hour, by the basin's equal-area extent
    areas = hydro_physics.basin_areas_m2(basins)
    runoff_da = runoff_da.copy(np.asarray(runoff_da.values) * areas[:, None])
    return hydro_physics.inflow_for_plants(basins, runoff_da, flowspeed, device=cutout.device,
                                           dtype=cutout.torch_dtype)


# ---------------------------------------------------------------------------
# dynamic line rating
# ---------------------------------------------------------------------------
def convert_line_rating(ds, psi, R, D=0.028, Ts=373, epsilon=0.6, alpha=0.6, per_unit=False,
                        device=None):
    """Ampacity [A] of one line from a dict of per-cell fields
    (``temperature``, ``wnd100m``, ``height``, ``wnd_azimuth``,
    ``influx_direct``, ``solar_altitude``, ``solar_azimuth``): tensors stay
    on their device, arrays go to ``device`` (default: the CUDA card).
    ``psi`` passes through ``radians()`` as in the reference;
    ``per_unit`` is accepted and unused, as there."""
    del per_unit
    target = None
    fields = {}
    for k, v in ds.items():
        if not isinstance(v, torch.Tensor):
            target = target or resolve_device(device)
            a = np.asarray(v)
            v = torch.as_tensor(a if a.dtype.kind == "f" else a.astype(float), device=target)
        fields[k] = v
    return line_rating_physics.ampacity(fields, psi, R, D, Ts, epsilon, alpha)


_LINE_PARAMS = {"D": 0.028, "Ts": 373, "epsilon": 0.6, "alpha": 0.6}
_LINE_FIELDS = ("temperature", "wnd100m", "height", "wnd_azimuth", "influx_direct",
                "solar_altitude", "solar_azimuth")


def line_rating(cutout, shapes, line_resistance, show_progress=False, dask_kwargs=None,
                _chunk_hours=None, **params):
    """Dynamic line rating [A] of line geometries as a (name, time)
    DataArray: the IEEE-738 ampacity of every cell a line touches (its
    intersection matrix), the line's the least of them.

    ``shapes``: LineStrings (a Series-like, whose ``.index`` names the
    lines, or a list); ``line_resistance`` [Ohm/m] and the keywords ``D``,
    ``Ts``, ``epsilon`` and ``alpha`` are numbers or one value a line.
    The line's azimuth is that of its end points, folded into [0, pi).
    All lines run at once on a padded (L, K) plan of their cells,
    gathered from the cutout's fields on its device, in time chunks of
    ``_chunk_hours`` (default: about 48e6 cell-hours a chunk).
    """
    del show_progress, dask_kwargs
    geoms = list(shapes.values) if _is_series(shapes) else list(shapes)
    labels = shapes.index if _is_series(shapes) else np.arange(len(geoms))
    I = sp.csr_matrix(cutout.intersectionmatrix(geoms))

    def azimuth(shape):
        coords = np.asarray(parse_geometry(shape).coords)
        start, end = coords[0], coords[-1]
        return np.arctan2(start[0] - end[0], start[1] - end[1])

    L = len(geoms)
    psi = np.array([azimuth(g) for g in geoms], dtype=float).reshape(L)
    psi = np.where(psi >= 0, psi, psi + np.pi)
    unknown = sorted(set(params) - set(_LINE_PARAMS))
    if unknown:
        # a misspelled parameter (Epsilon=) must not pass for the default
        raise ValueError(f"unexpected line-rating parameters {unknown}; "
                         f"expected {list(_LINE_PARAMS)}")
    cols = {"psi": psi, "R": line_resistance, **{k: params.get(k, v)
                                                 for k, v in _LINE_PARAMS.items()}}
    cols = {k: np.broadcast_to(np.asarray(v, dtype=float), (L,)).copy() for k, v in cols.items()}
    if any(np.isnan(v).any() for v in cols.values()):
        raise ValueError("Nan values encountered.")

    # the padded (L, K) plan from the CSR structure: .indices runs row by
    # row, so the row-major mask positions line up with it
    counts = np.diff(I.indptr)
    K = max(1, int(counts.max()) if L else 1)
    mask = np.arange(K)[None, :] < counts[:, None]
    cell_idx = np.zeros((L, K), dtype=np.int64)
    cell_idx[mask] = I.indices

    T = len(cutout.grid_desc.time)
    fields = cutout.fields()
    if getattr(cutout, "_mesh", None) is not None:
        # a line's cells lie anywhere on the grid: the sharded fields are
        # gathered on the mesh's first device
        fields = {k: v.gather() for k, v in fields.items()}
    dev = fields["temperature"].device
    if "solar_altitude" not in fields or "solar_azimuth" not in fields:
        eph, lon, lat = _solar_inputs(cutout, {})  # no stored angles: the ephemeris
        sp_ = solar.solar_position(eph["declination"], eph["hour_angle0"], lon, lat)
        fields = {**fields, "solar_altitude": sp_["altitude"].to(dev),
                  "solar_azimuth": sp_["azimuth"].to(dev)}
    flat_idx = torch.as_tensor(cell_idx.ravel(), device=dev)
    dmask = torch.as_tensor(mask, device=dev)
    static = {v: fields[v].reshape(-1).index_select(0, flat_idx).reshape(L, K, 1)
              for v in _LINE_FIELDS if fields[v].dim() == 2}
    chunk = _chunk_hours or max(1, min(T, int(48e6 // max(1, L * K))))
    pieces = []
    for t0 in range(0, T, chunk):
        t1 = min(T, t0 + chunk)
        gathered = dict(static)
        for v in _LINE_FIELDS:
            if v not in static:
                # (Tc, C) columns of the plan's cells -> (L, K, Tc); every
                # hour is rated on its own, so a short last chunk needs no
                # padding
                g = fields[v][t0:t1].reshape(t1 - t0, -1).index_select(1, flat_idx)
                gathered[v] = g.reshape(t1 - t0, L, K).permute(1, 2, 0)
        pieces.append(line_rating_physics.batched_line_rating(
            gathered, dmask, *(cols[k] for k in ("psi", "R", "D", "Ts", "epsilon", "alpha"))))
    out = (torch.cat(pieces, dim=1).cpu().numpy() if pieces
           else np.zeros((L, T), dtype=cutout.dtype))
    return DataArray(out, coords={"name": labels, "time": cutout.grid_desc.time_index},
                     dims=("name", "time"), attrs={"units": "A"})


# Streaming contract: a converter marked _time_elementwise treats every
# hour on its own, so the streamer may slide the tail window back to a
# full chunk and drop the overlap; _day_aligned converters resample whole
# days and stream over day-aligned chunks of varying length instead.
for _f in (convert_wind, convert_pv, convert_irradiation, convert_solar_thermal, convert_csp,
           convert_temperature, convert_soil_temperature, convert_dewpoint_temperature,
           convert_coefficient_of_performance, convert_runoff):
    _f._time_elementwise = True
for _f in (convert_heat_demand, convert_cooling_demand):
    _f._day_aligned = True
del _f
