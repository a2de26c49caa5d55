"""Converters: weather fields -> energy time series (counterpart of
``atlite_tpu/convert.py``), for wind and PV.

``convert_and_aggregate`` is the gateway: it composes the spatial
aggregation (``matrix``, ``layout``), per-unit normalisation and the
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

import re
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import scipy.sparse as sp
import torch
from torch.profiler import record_function

from atlite_tpu_torch.aggregate import aggregate_matrix, spdiag, spmm_closure
from atlite_tpu_torch.core import timeutil
from atlite_tpu_torch.dataarray import DataArray
from atlite_tpu_torch.physics import irradiation, orientation, pv as pv_physics, solar
from atlite_tpu_torch.physics import wind as wind_physics
from atlite_tpu_torch.resource import get_solarpanelconfig, get_windturbineconfig


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
                          shapes=None, per_unit=False, return_capacity=False,
                          aggregate_time="legacy", **convert_kwds):
    """Convert, then aggregate in space and time.

    Returns a DataArray (bus, time) with ``matrix`` or ``layout``, else
    (time, y, x); values on the host.  ``time_chunk`` streams the
    conversion over chunks of that many hours, and ``stream_pack="int16"``
    packs each chunk's upload (see ``Cutout.pack_params``).
    """
    if aggregate_time not in ("sum", "mean", "legacy", None):
        raise ValueError(f"aggregate_time must be 'sum', 'mean', 'legacy', or None, "
                         f"got {aggregate_time!r}")
    if aggregate_time == "legacy":
        warnings.warn("aggregate_time='legacy' is deprecated and will be removed in a "
                      "future release. Pass 'sum', 'mean', or None explicitly.",
                      FutureWarning, stacklevel=2)
    if shapes is not None:
        raise NotImplementedError("shapes= needs the GIS slice, not ported yet (ROADMAP "
                                  "queue 1, item 8); pass an indicator matrix as matrix=")

    time_chunk = convert_kwds.pop("time_chunk", None)
    stream_pack = convert_kwds.pop("stream_pack", None)
    if stream_pack not in (None, "int16"):
        raise ValueError(f"stream_pack must be 'int16' or None, got {stream_pack!r}")
    if time_chunk is None:
        # a stored chunk size is the streaming default
        time_chunk = (cutout.chunks or {}).get("time")
        if time_chunk and time_chunk >= len(cutout.grid_desc.time):
            time_chunk = None
    if stream_pack is not None and not time_chunk:
        raise ValueError("stream_pack requires streamed conversion: pass a time_chunk= "
                         "smaller than the time axis")

    if matrix is None and layout is None:
        if per_unit or return_capacity:
            raise ValueError("One of `matrix`, `shapes` and `layout` must be "
                             "given for `per_unit` or `return_capacity`")
        if time_chunk:
            da = _chunked_convert(cutout, convert_func, time_chunk, stream_pack=stream_pack,
                                  **convert_kwds)
        else:
            da = convert_func(cutout, **convert_kwds)
        agg = "sum" if aggregate_time == "legacy" else aggregate_time
        return _aggregate_time_da(da, agg).load()

    # the matrix is composed before converting: the streamer aggregates
    # inside each chunk
    if matrix is not None:
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
    if layout is not None:
        lv = _align_layout(layout, cutout)
        matrix = sp.csr_matrix(lv[None, :]) if matrix is None else matrix @ spdiag(lv)

    bus_name = getattr(index, "name", None) or "bus"
    index = np.arange(matrix.shape[0]) if index is None else np.asarray(index)
    if index.ndim != 1:
        raise ValueError("index must have a single dimension")

    if time_chunk:
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
    results = results.load()
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
    if convert_func is convert_pv:
        solar_vars = {"solar_altitude", "solar_azimuth"} & have
        influx = ({"influx"} if "influx" in have else
                  {"influx_direct", "influx_diffuse"}) | {"influx_toa"}
        albedo = {"albedo"} if "albedo" in have else {"outflux"} & have
        return influx | albedo | solar_vars | ({"humidity"} & have) | {"temperature"}
    return None


def _chunk_bounds(cutout, time_chunk):
    """[t0, t1, ...] chunk boundaries along the hour axis."""
    T = len(cutout.grid_desc.time)
    return list(range(0, T, time_chunk)) + [T]


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
    host memory.
    """

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
    chunk and drop the overlap, so every chunk has one shape.
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

    bounds = _chunk_bounds(cutout, time_chunk)
    windows = [[bounds[i], bounds[i + 1], 0] for i in range(len(bounds) - 1)]
    if getattr(convert_func, "_time_elementwise", False) and len(windows) > 1:
        t0_l, t1_l, _ = windows[-1]
        if t1_l - t0_l < time_chunk and T >= time_chunk:
            windows[-1] = [T - time_chunk, T, time_chunk - (t1_l - t0_l)]

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
# solar: pv
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


def _solar_chain(fields, eph, lon, lat, orient, tracking, trigon_model, clearsky_model,
                 altitude_threshold=1.0, irradiation_kind="total", panel=None):
    """Solar position -> orientation -> transposition [-> panel model]."""
    sp_ = _resolve_solar_position(fields, eph, lon, lat, trig_carry=True)
    surf = orientation.surface_orientation(sp_, lat, orient, tracking)
    irr = irradiation.tilted_irradiation(
        fields, sp_, surf, trigon_model=trigon_model, clearsky_model=clearsky_model,
        tracking=tracking, altitude_threshold=altitude_threshold,
        irradiation=irradiation_kind)
    if panel is not None:
        return pv_physics.solar_panel_power(irr, fields["temperature"], panel)
    return irr


def _run_solar_chain(cutout, orient, tracking=None, trigon_model="simple",
                     clearsky_model="simple", irradiation_kind="total", panel=None):
    if not isinstance(orient, dict) or "kind" not in orient:
        orient = orientation.get_orientation(orient)
    fields = cutout.fields()
    g = cutout.grid_desc

    def put(a):
        return torch.as_tensor(np.asarray(a), dtype=cutout.torch_dtype, device=cutout.device)

    eph = None
    if not ("solar_altitude" in fields and "solar_azimuth" in fields):
        eph = {k: put(v) for k, v in timeutil.solar_ephemeris(g.time, "0h").items()}
    out = _solar_chain(fields, eph, put(g.x), put(g.y), orient, tracking, trigon_model,
                       clearsky_model, irradiation_kind=irradiation_kind, panel=panel)
    da = _tyx(cutout, out)
    if panel is not None:
        da.attrs["units"] = "kWh/kWp"
        da.name = "specific generation"
    else:
        da.attrs["units"] = "W m**-2"
    return da


def convert_pv(cutout, panel, orientation, tracking=None, trigon_model="simple",
               clearsky_model="simple"):
    return _run_solar_chain(cutout, orientation, tracking, trigon_model, clearsky_model,
                            panel=panel)


def pv(cutout, panel, orientation, tracking=None, clearsky_model=None,
       trigon_model="simple", **params):
    """Downward radiation + temperature -> PV generation."""
    if isinstance(panel, str):
        panel = get_solarpanelconfig(panel)
    return cutout.convert_and_aggregate(
        convert_func=convert_pv, panel=panel, orientation=orientation, tracking=tracking,
        clearsky_model=clearsky_model, trigon_model=trigon_model, **params)


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
    """Wind generation: hub-height extrapolation + power curve."""
    if smooth:
        raise NotImplementedError("power-curve smoothing is not ported yet "
                                  "(ROADMAP queue 1, item 10: resource.py)")
    turbine = get_windturbineconfig(turbine, add_cutout_windspeed=add_cutout_windspeed)
    return cutout.convert_and_aggregate(
        convert_func=convert_wind, turbine=turbine,
        interpolation_method=interpolation_method, **params)


# Streaming contract: a converter marked _time_elementwise treats every
# hour on its own, so the streamer may slide the tail window back to a
# full chunk and drop the overlap.
for _f in (convert_wind, convert_pv):
    _f._time_elementwise = True
del _f
