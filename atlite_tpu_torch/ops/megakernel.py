"""Fused wind + PV + bus aggregation (counterpart of
``atlite_tpu/ops/megakernel.py``).

``wind_pv_bus_megakernel`` launches the hand-written CUDA kernel
``csrc/megakernel.cu`` for tensors on a CUDA card and runs the plain
version, ``wind_pv_bus_plain`` (the physics modules and
``aggregate.dense_spmm`` in turn), for tensors on the CPU.  Both follow the
step they fuse, including the sparse NaN rule of the aggregation: a NaN
cell poisons only the buses whose matrix row is nonzero there.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from atlite_tpu_torch import aggregate
from atlite_tpu_torch.physics import irradiation, orientation, pv, wind
from atlite_tpu_torch.profiling import span

FIELD_ORDER = (
    "wnd100m", "roughness", "solar_altitude", "solar_azimuth",
    "influx_toa", "influx_direct", "influx_diffuse", "albedo", "temperature",
)
# kMaxKnots of csrc/megakernel.cu: the kernel keeps the power curve in
# shared memory (its launcher refuses more)
MAX_KNOTS = 256

# Huld panel parameters the kernel takes, in its order, with the defaults
# of the JAX kernel
_PANEL_KEYS = (
    ("k_1", None), ("k_2", None), ("k_3", None), ("k_4", None),
    ("k_5", None), ("k_6", None), ("c_temp_irrad", 0.035),
    ("c_temp_amb", 1.0), ("r_tmod", 298.0), ("r_irradiance", 1000.0),
    ("inverter_efficiency", 1.0),
)


def _panel(panel):
    """Complete Huld parameters; the kernel computes no other model."""
    if panel.get("model", "huld") != "huld":
        raise ValueError(f"the fused step computes the Huld model only, "
                         f"not {panel['model']!r}")
    missing = [k for k, d in _PANEL_KEYS if d is None and k not in panel]
    if missing:
        raise KeyError(f"panel lacks {missing}")
    return {k: float(panel.get(k, d)) for k, d in _PANEL_KEYS}


def _check_tensor(name, t):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, not {type(t).__name__}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, not {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check(fields, lat_cell, V, POWn):
    """Raise on resident inputs the kernel does not take; returns (T, C,
    device)."""
    missing = [k for k in FIELD_ORDER if k not in fields]
    if missing:
        raise KeyError(f"fields lack {missing}")
    tensors = {**{k: fields[k] for k in FIELD_ORDER}, "lat_cell": lat_cell, "V": V, "POWn": POWn}
    for name, t in tensors.items():
        _check_tensor(name, t)
    device = fields["wnd100m"].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"tensors must lie on the CPU or a CUDA card, not {device}")
    off = [name for name, t in tensors.items() if t.device != device]
    if off:
        raise ValueError(f"{off} are not on {device}, where the fields are")
    if fields["wnd100m"].ndim != 2:
        raise ValueError("fields must be (T, C)")
    T, C = fields["wnd100m"].shape
    bad = [k for k in FIELD_ORDER if fields[k].shape != (T, C)]
    if bad:
        raise ValueError(f"fields {bad} are not of shape {(T, C)}")
    if T < 1 or C < 1:
        raise ValueError(f"empty fields {(T, C)}")
    if lat_cell.shape != (C,):
        raise ValueError(f"lat_cell must be ({C},), not {tuple(lat_cell.shape)}")
    if V.ndim != 1 or V.shape != POWn.shape:
        raise ValueError("V and POWn must be 1-D of one length")
    if not 2 <= V.shape[0] <= MAX_KNOTS:
        raise ValueError(f"the power curve needs 2 to {MAX_KNOTS} knots, "
                         f"not {V.shape[0]}")
    return T, C, device


def _check_matrix(matrix, C, device):
    """Raise on a matrix the kernel does not take; returns B."""
    _check_tensor("matrix", matrix)
    if matrix.device != device:
        raise ValueError(f"['matrix'] are not on {device}, where the fields are")
    if matrix.ndim != 2 or matrix.shape[1] != C or matrix.shape[0] < 1:
        raise ValueError(f"matrix must be (B, {C}), not {tuple(matrix.shape)}")
    return matrix.shape[0]


# the kernel's unit of work (kRows x kCells of csrc/megakernel.cu): a
# block walks units of 8 time rows x 64 cells
UNIT_ROWS = 8
UNIT_CELLS = 64


def knot_table(V, POWn):
    """The power-curve table the kernel searches: (P, 4) float32, P the
    knot count rounded up to a power of two.  Row k holds (V[k], POWn[k],
    slope of the segment [V[k], V[k+1]), 0); rows past the knots hold
    (+inf, 0, 0, 0), so an upper-bound search over column 0 counts the
    knots <= a query in log2(P) + 1 compares.  A zero-width segment (a
    duplicated knot) gets slope 0: no query falls in it."""
    K = V.shape[0]
    P = 1 << (K - 1).bit_length()
    left, right, _, slope = wind.curve_segments(V, POWn)
    table = torch.zeros((P, 4), dtype=V.dtype, device=V.device)
    table[:, 0] = float("inf")
    table[:K, 0] = V
    table[:K, 1] = POWn
    table[:K - 1, 2] = torch.where(right == left, 0.0, slope)
    return table


def work_split(T, C, n_blocks):
    """The persistent grid's work: units are (time tile, 64-cell chunk)
    in row-major order, U = ceil(T / 8) * ceil(C / 64) of them; block k
    takes the contiguous run [block_unit[k], block_unit[k+1]), so that
    runs differ by at most one unit.  Runs are cut into items at time-tile
    edges: item i is units [item_start[i], item_start[i+1]) of one tile,
    and writes its own (8, B) partials.  Returns numpy int32 arrays
    block_unit (N+1), block_item (N: a block's first item), tile_item
    (ceil(T/8)+1: the items of tile t are [tile_item[t], tile_item[t+1]))
    and item_start (n_items+1), with N = min(n_blocks, U)."""
    n_cb = -(-C // UNIT_CELLS)
    n_tt = -(-T // UNIT_ROWS)
    U = n_tt * n_cb
    N = max(1, min(n_blocks, U))
    block_unit = np.arange(N + 1, dtype=np.int64) * U // N
    item_start = np.union1d(block_unit, np.arange(n_tt + 1, dtype=np.int64) * n_cb)
    return {
        "block_unit": block_unit.astype(np.int32),
        "block_item": np.searchsorted(item_start, block_unit[:-1]).astype(np.int32),
        "tile_item": np.searchsorted(item_start, np.arange(n_tt + 1) * n_cb).astype(np.int32),
        "item_start": item_start.astype(np.int32),
    }


@functools.cache
def _library():
    """The built kernel library, its C signatures declared."""
    from atlite_tpu_torch.ops import _build

    lib = _build.library("megakernel")
    lib.wind_pv_bus_occupancy.restype = ctypes.c_int
    lib.wind_pv_bus_occupancy.argtypes = ([ctypes.c_int] * 2
                                          + [ctypes.POINTER(ctypes.c_int)] * 3)
    lib.wind_pv_bus_launch.restype = ctypes.c_int
    lib.wind_pv_bus_launch.argtypes = (
        [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
        + [ctypes.c_void_p] * 6)
    lib.wind_pv_bus_error_string.restype = ctypes.c_char_p
    lib.wind_pv_bus_error_string.argtypes = [ctypes.c_int]
    return lib


def _raise_on(rc, what):
    if rc != 0:
        msg = _library().wind_pv_bus_error_string(rc).decode()
        raise RuntimeError(f"wind_pv_bus_megakernel {what} failed: CUDA error {rc} ({msg})")


def occupancy(device_index, B):
    """(resident blocks an SM, shared-memory bytes a block, buses a pass)
    of the kernel that takes B buses on card ``device_index``."""
    per_sm, smem, bus_tile = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    _raise_on(_library().wind_pv_bus_occupancy(device_index, B, ctypes.byref(per_sm),
                                               ctypes.byref(smem), ctypes.byref(bus_tile)),
              "occupancy query")
    return per_sm.value, smem.value, bus_tile.value


@functools.cache
def _grid(device_index, T, C, B):
    """(block count, the work split on the card, n_items, passes over the
    buses) of one shape: a whole number of resident blocks on every SM."""
    per_sm, _, bus_tile = occupancy(device_index, B)
    if per_sm < 1:
        raise RuntimeError("wind_pv_bus_megakernel: no block fits an SM")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    split = work_split(T, C, sms * per_sm)
    device = torch.device("cuda", device_index)
    on_card = {k: torch.as_tensor(split[k], device=device)
               for k in ("block_unit", "block_item", "tile_item")}
    n_items = len(split["item_start"]) - 1
    return len(split["block_unit"]) - 1, on_card, n_items, -(-B // bus_tile)


def wind_pv_bus_plain(fields, lat_cell, matrix, V, POWn, panel, hub_height=80.0):
    """Plain PyTorch version of the fused step, module by module.

    The (T, C) fields are viewed as (T, C, 1), cells on the latitude axis,
    so that ``lat_cell`` broadcasts as the modules' (Y,) latitudes.
    """
    f = {k: fields[k][..., None] for k in FIELD_ORDER}
    cf_w = wind.power_curve(wind.extrapolate_wind_speed(f, hub_height), V, POWn, 1.0)
    sp = {"altitude": f["solar_altitude"], "azimuth": f["solar_azimuth"]}
    surf = orientation.surface_orientation(sp, lat_cell, {"kind": "latitude_optimal"})
    irr = irradiation.tilted_irradiation(f, sp, surf, trigon_model="simple",
                                         clearsky_model="simple")
    cf_p = pv.power_huld(irr, f["temperature"], _panel(panel))
    T = cf_w.shape[0]
    return (aggregate.dense_spmm(cf_w.reshape(T, -1), matrix),
            aggregate.dense_spmm(cf_p.reshape(T, -1), matrix))


class Plan:
    """The fused step's launch, built once for its resident inputs and
    launched with any matrix over their cells.

    Building it checks ``fields`` (FIELD_ORDER keys, (T, C) float32),
    ``lat_cell`` (C,), ``V`` and ``POWn`` (2 to MAX_KNOTS knots) and
    ``panel`` (Huld parameters), and holds them.  On a CUDA card it also
    holds, for the card and the CUDA stream current there: the knot
    ``table`` (``knot_table(V, POWn)``, built when None), the nine field
    pointers and the rounded panel parameters as C arrays, whether the
    fields share a 16-byte phase, and scratch that every launch rewrites in
    full: the cells' panel geometry, and per bus count the work split, the
    (2, n_items, 8, B) partial sums and, where the matrix takes a padded
    copy, that copy.  Stream order keeps the scratch of one launch from
    the next, so a plan launches only on its own stream.  The argument
    building runs in a ``pack 0:T`` span, on the card only.

    ``launch(matrix)`` checks the (B, C) matrix, allocates the (2, T, B)
    output and launches the kernel; on the CPU it runs the plain version.
    The plan caches no matrix: the launch's prologue pads the matrix it is
    given.  ``wind_pv_bus_megakernel.planned`` counts the launches of a
    plan that had launched before.
    """

    def __init__(self, fields, lat_cell, V, POWn, table, panel, hub_height=80.0):
        self.T, self.C, self.device = _check(fields, lat_cell, V, POWn)
        prm = _panel(panel)
        self._inputs = (fields, lat_cell, V, POWn, panel, hub_height)
        self._launched = False
        if self.device.type == "cpu":
            return
        with span("pack", 0, self.T):
            if table is None:
                table = knot_table(V, POWn)
            if not (table.device == self.device and table.dtype == torch.float32
                    and table.is_contiguous()
                    and table.shape == (1 << (V.shape[0] - 1).bit_length(), 4)):
                raise ValueError("table must be knot_table(V, POWn) on the fields' device")
            # the kernel multiplies by the reciprocal, rounded once here
            prm["r_irradiance"] = float(np.float32(1.0) / np.float32(prm["r_irradiance"]))
            ptrs = [fields[k].data_ptr() for k in FIELD_ORDER]
            self._staged16 = all((p ^ ptrs[0]) % 16 == 0 for p in ptrs)
            self._lib = _library()
            self._stream = torch.cuda.current_stream(self.device).cuda_stream
            self._table = table
            self._params = (ctypes.c_float * 12)(float(hub_height), *prm.values())
            self._panel_cells = torch.empty((self.C, 4), dtype=torch.float32, device=self.device)
            self._head = (self.device.index, (ctypes.c_void_p * len(FIELD_ORDER))(*ptrs),
                          lat_cell.data_ptr())
            # C % 4 != 0: every matrix takes a padded copy; else a matrix off
            # a 16-byte boundary does
            self._pad = self.C % 4 != 0
            self._parts = {}  # B -> partial sums
            self._buses = {}  # (B, padded) -> (arguments, passes, their buffers)

    def _bus_args(self, B, padded):
        """The launch's arguments between the matrix's pointer and the
        output's for B buses, the passes over them and their buffers."""
        got = self._buses.get((B, padded))
        if got is None:
            T, C, device = self.T, self.C, self.device
            n_blocks, split, n_items, n_passes = _grid(device.index, T, C, B)
            part = self._parts.get(B)
            if part is None:
                part = self._parts[B] = torch.empty((2, n_items, UNIT_ROWS, B),
                                                    dtype=torch.float32, device=device)
            # the matrix with 16-byte rows, filled by the kernel's prologue
            mat_pad = torch.empty((B, -(-C // 4) * 4), dtype=torch.float32, device=device) \
                if padded else None
            args = (None if mat_pad is None else mat_pad.data_ptr(), self._table.data_ptr(),
                    self._table.shape[0], self._inputs[2].shape[0], T, C, B,
                    split["block_unit"].data_ptr(), split["block_item"].data_ptr(),
                    split["tile_item"].data_ptr(), n_blocks, n_items, self._params,
                    self._panel_cells.data_ptr(), part.data_ptr())
            got = self._buses[(B, padded)] = (args, n_passes, (part, mat_pad))
        return got

    def launch(self, matrix):
        """(wind_bus, pv_bus), each (T, B), of the step with the (B, C)
        float32 ``matrix``; on the card the argument building runs in a
        ``pack 0:T`` span, the launch in ``convert 0:T``."""
        if self.device.type == "cpu":
            _check_matrix(matrix, self.C, self.device)
            fields, lat_cell, V, POWn, panel, hub_height = self._inputs
            out = wind_pv_bus_plain(fields, lat_cell, matrix, V, POWn, panel, hub_height)
            self._count_reuse()
            return out
        T = self.T
        with span("pack", 0, T):
            B = _check_matrix(matrix, self.C, self.device)
            if torch.cuda.current_stream(self.device).cuda_stream != self._stream:
                raise ValueError("a plan launches only on the CUDA stream it was built under")
            ptr = matrix.data_ptr()
            args, n_passes, _ = self._bus_args(B, self._pad or ptr % 16 != 0)
            out = torch.empty((2, T, B), dtype=torch.float32, device=self.device)
        with span("convert", 0, T):
            _raise_on(self._lib.wind_pv_bus_launch(*self._head, ptr, *args, out.data_ptr(),
                                                   self._stream, None), "launch")
        wind_pv_bus_megakernel.launches += 1
        wind_pv_bus_megakernel.bus_passes += n_passes
        wind_pv_bus_megakernel.staged16 += self._staged16
        self._count_reuse()
        return out[0], out[1]

    def _count_reuse(self):
        wind_pv_bus_megakernel.planned += self._launched
        self._launched = True


def wind_pv_bus_megakernel(fields, lat_cell, matrix, V, POWn, panel, hub_height=80.0,
                           table=None, plan=None):
    """Fused wind + PV + aggregation: ``Plan(fields, lat_cell, V, POWn,
    table, panel, hub_height).launch(matrix)``.

    fields: dict of (T, C) float32 tensors (FIELD_ORDER keys, wind at
    100 m); lat_cell: (C,) latitude of each flattened cell [deg]; matrix:
    (B, C) aggregation weights; V, POWn: power-curve knots (2 to
    MAX_KNOTS) and normalised power; panel: Huld parameters; table:
    ``knot_table(V, POWn)``, from a caller that keeps it across calls
    (built here when None; the plain version does not read it); plan: the
    ``Plan`` of these very fields, lat_cell, V, POWn, panel and hub height,
    from a caller that keeps it across calls (built here when None; it
    holds its own table; raises when built from other inputs).  Returns
    (wind_bus, pv_bus), each (T, B).  CUDA tensors go through the kernel
    (``launches`` counts the launches, ``bus_passes`` its passes over the
    buses: ceil(B / the bus tile of ``occupancy``) a launch), CPU tensors
    through the plain version.  ``staged16`` counts the launches whose
    fields and matrix were all staged by 16-byte copies: every launch but
    those whose nine fields' bases differ in their 16-byte phase (a matrix
    whose rows are not 16-byte aligned, as where C % 4 != 0, is copied
    with a padded pitch by the launch's prologue).  ``planned`` counts the
    calls, on either route, that reused a plan (``Plan``; a caller that
    keeps one, as ``entry.step_fn`` does).  On the card the argument
    building runs in ``pack 0:T`` spans, the launch in ``convert 0:T``.
    """
    if plan is None:
        plan = Plan(fields, lat_cell, V, POWn, table, panel, hub_height)
    elif (any(a is not b for a, b in zip(plan._inputs, (fields, lat_cell, V, POWn, panel)))
          or plan._inputs[5] != hub_height):
        raise ValueError("plan was built from other inputs")
    return plan.launch(matrix)


wind_pv_bus_megakernel.launches = 0
wind_pv_bus_megakernel.bus_passes = 0
wind_pv_bus_megakernel.staged16 = 0
wind_pv_bus_megakernel.planned = 0
