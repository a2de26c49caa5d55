#!/usr/bin/env python3
"""Drive the PyTorch port's headline step on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile ops/csrc/*.cu (timed, set-up);
  3. inputs: the bench recipe at T=2184, Y=96, X=128, B=20 (three months
     of Europe at 0.25 deg, 20 buses);
  4. main path: ``entry()``'s step on the card, at the example shape and
     the bench shape; the fused kernel's launch count must rise, and a
     second call must repeat the series bit for bit;
  5. plain version on the card (TF32 off), same tensors, and again with
     the roughness varying by hour in every cell: max abs diff within
     1e-5 * max|plain| per output, NaN masks identical;
  6. NaN cells in ``wnd100m``: the NaN masks of kernel and plain version
     equal "the bus row touches a NaN cell";
  7. ragged shapes (no dimension a tile multiple, and B over one bus
     tile) against the plain version on the card and on the CPU;
  8. timing with CUDA events: the fused step, its cell-hours/s and byte
     bound, in turns with the same work building the knot table at every
     call and with the roughness varying by hour; the host's enqueue time
     a step; the plain version, and the two torch.matmul aggregations
     alone; then the step's device time by kernel from torch.profiler,
     and the fused kernel's own time, GB/s and share of its byte bound;
     the kernel's registers, spills, shared memory and blocks an SM; the
     step at B=256 (same fields) against the plain version and beside
     B=20;
  9. continental inputs: a synthetic Cutout on the 241 x 481 grid of
     bench_continental.py over T=1440 h (two 720 h chunks; the full year
     is cut for time), prepared with wind, influx and temperature, and a
     (2048, C) region matrix (32 x 64 rectangles) that must take the
     banded route;
 10. the continental path: ``cutout.wind``/``cutout.pv`` with the matrix,
     resident, streamed raw and streamed int16-packed in 720 h chunks;
     streamed against resident (raw within 1e-5 * max, packed within the
     bounds of bench_continental.py), the first 48 h against the plain
     path on the CPU; wall seconds, cell-hours/s, per-chunk ms of host
     packing (the pinned buffers' allocation apart), conversion and
     banded aggregation, read from the streamer's profiler ranges, and of
     the copy, from the trace's pinned transfers (or its range), and the
     device's idle share over each run (torch.profiler); a step whose
     device record the trace did not link is printed as missing, not
     failed;
 11. the BSR entry: ``bsr_spmm_kernel`` on the wind capacity factors of
     the first 720 h against the plain ``bsr_spmm`` (same bits on a
     second call), after ``stage_bsr`` builds the kernel's compact form on
     the host and uploads it (timed as set-up); NaN cells, a NaN at a
     stored zero of a row with nonzeros, +Inf and -Inf cells (identical
     NaN masks and +-Inf entries), an empty row block (exact zeros), two
     ragged shapes on the card and the CPU, the matrix with its row
     blocks paired so that super rows merge nothing; timing against its
     bound (a product per nonzero entry of the blocks, or the bytes of
     the field, the compact form and the output), the paired-apart
     matrix, the plain version, a dense torch.matmul, torch.sparse.mm on
     a sparse BSR tensor and on the CSR matrix (cuSPARSE: from the (T, C)
     field, its transpose counted, and from a field transposed
     beforehand); the kernel's registers, spills, shared memory and
     blocks an SM.
Then one JSON line of kernels and, last, the result line.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch

from atlite_tpu_torch import Cutout, aggregate, build_inputs, entry, from_jax_inputs
from atlite_tpu_torch.convert import convert_wind
from atlite_tpu_torch.entry import HUB_HEIGHT, PANEL
from atlite_tpu_torch.ops import _build
from atlite_tpu_torch.ops import bsr_spmm as bsr_ops
from atlite_tpu_torch.ops.bsr_spmm import (
    banded_width,
    bsr_spmm,
    bsr_spmm_kernel,
    stage_bsr,
    to_bsr,
)
from atlite_tpu_torch.ops.megakernel import (
    FIELD_ORDER,
    occupancy,
    wind_pv_bus_megakernel,
    wind_pv_bus_plain,
)
from atlite_tpu_torch.resource import get_windturbineconfig

BENCH_SHAPE = (2184, 96, 128, 20)
WIDE_B = 256                # a second bus count at the bench's fields
RAGGED_SHAPES = ((30, 7, 13, 3), (45, 9, 20, 37))
REL_TOL = 1e-5              # max abs diff allowed, relative to max |plain|
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOPS = 67e12          # H100 SXM data sheet, outside the tensor cores
PHYS_FLOPS = 70             # float ops of the physics chain per cell-hour
# the continental cut: bench_continental.py's grid and regions, 1440 h
CONT_DX, CONT_DY = 30 / 480, 25 / 240
CONT_TIME = slice("2013-01-01", "2013-03-01")
CONT_REGIONS = (32, 64)
CHUNK = 720
CONT_SHAPE = (2 * CHUNK, 241, 481)  # (T, Y, X)
BSR_RAGGED = ((333, 5003, 77), (97, 2049, 130))  # (T, C, B) at block 8 x 256
# the streamer's profiler ranges, one per step and chunk (convert.py)
STEP = re.compile(r"(pin|pack|copy|convert|aggregate) (\d+):(\d+)$")
PINNED_COPY = "Memcpy HtoD (Pinned -> Device)"  # the profiler's name for it


def log(msg):
    print(msg, flush=True)


# one entry function of ptxas -v: its name, then its spills and registers
PTXAS_ENTRY = re.compile(r"Compiling entry function '_Z\w*?\d+([a-z][a-z_]*_kernel)(?:ILi(\d+)E)?")
PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_summary(text):
    """{kernel name (with its template argument): (registers, spill store
    bytes, spill load bytes)} from a build log of nvcc -Xptxas -v."""
    out, name, spill = {}, None, (0, 0)
    for line in text.splitlines():
        if m := PTXAS_ENTRY.search(line):
            name = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
        elif (m := PTXAS_SPILL.search(line)) and name:
            spill = (int(m.group(1)), int(m.group(2)))
        elif (m := PTXAS_REGS.search(line)) and name:
            out[name] = (int(m.group(1)), *spill)
            name, spill = None, (0, 0)
    return out


def compare(name, got, want):
    """Max abs diff of two (T, B) series; raises unless the NaN masks and the
    +-Inf entries are identical and the diff of the finite entries is within
    REL_TOL * their max |want|."""
    got, want = got.double().cpu(), want.double().cpu()
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        raise RuntimeError(f"{name}: NaN masks differ")
    inf = torch.isinf(want)
    if not (torch.equal(torch.isinf(got), inf) and torch.equal(got[inf], want[inf])):
        raise RuntimeError(f"{name}: +-Inf entries differ")
    ok = torch.isfinite(want)
    if not ok.any():
        return 0.0
    err = float((got[ok] - want[ok]).abs().max())
    scale = float(want[ok].abs().max())
    log(f"  {name}: max abs diff {err:.3e} (max |plain| {scale:.4g}, "
        f"tolerance {REL_TOL * scale:.3e})")
    if not err <= REL_TOL * scale:
        raise RuntimeError(f"{name}: max abs diff {err} above {REL_TOL} * {scale}")
    return err


def cuda_ms(fn, reps, warmup=2):
    """Mean ms of fn() on the card, by CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_breakdown(fn, reps=5):
    """{kernel name: device ms a call} over ``reps`` calls, from
    torch.profiler; empty when the profiler records no device time."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    with profiled() as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / 1e3 / reps for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0}


def device_idle(prof, wall_ms):
    """(busy ms, idle share) of the card over a run of ``wall_ms``: the
    union of the device intervals torch.profiler recorded (kernels and
    copies on every stream); None when it recorded none."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and not STEP.match(e.name)
                   and e.time_range.end > e.time_range.start)
    if not spans:
        return None
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + hi - lo, a, b
        else:
            hi = max(hi, b)
    busy = (busy + hi - lo) / 1e3
    return busy, max(0.0, 1 - busy / wall_ms)


def chunk_steps(prof):
    """({(t0, t1): {step: ms}}, n) of a streamed call, from the streamer's
    profiler ranges: host ms for pin and pack (the worker thread), device
    ms of the kernels launched inside convert and aggregate.  The trace
    does not always link a device record to its range (a chunk's copy, or
    the last kernels of a call, have gone missing), so such a step reads
    0.  When the trace holds one pinned host-to-card transfer a chunk
    (only the streamer's side stream makes them), copy is the k-th of
    them, linked or not; n is the number of such transfers."""
    from torch.autograd import DeviceType

    out, copies = {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name == PINNED_COPY:
            copies.append((e.time_range.start, e.time_range.elapsed_us() / 1e3))
        m = STEP.match(e.name)
        if m is None or e.device_type != DeviceType.CPU:
            continue
        step = m.group(1)
        ms = (e.time_range.elapsed_us() if step in ("pin", "pack") else
              e.device_time_total) / 1e3
        steps = out.setdefault((int(m.group(2)), int(m.group(3))), {})
        steps[step] = steps.get(step, 0.0) + ms
    out = dict(sorted(out.items()))
    if len(copies) == len(out):
        for steps, (_, ms) in zip(out.values(), sorted(copies)):
            steps["copy"] = ms
    return out, len(copies)


def step_ms(ms, fmt):
    """A step of the per-chunk split as printed: its ms, or its absence."""
    return f"{ms:{fmt}} ms" if ms else "not in the trace"


def profiled():
    """torch.profiler over the CPU (every thread, the streamer's worker
    included) and the card."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))


def region_matrix(cutout, ny, nx):
    """(ny * nx, C) float32 matrix: each cell, by its centre, to one of
    ny x nx equal rectangles over the cutout's extent, weight 1."""
    g = cutout.grid_desc
    gx = np.linspace(g.x[0], g.x[-1], nx + 1)
    gy = np.linspace(g.y[0], g.y[-1], ny + 1)
    ix = np.clip(np.searchsorted(gx, g.x, side="right") - 1, 0, nx - 1)
    iy = np.clip(np.searchsorted(gy, g.y, side="right") - 1, 0, ny - 1)
    bus = (iy[:, None] * nx + ix[None, :]).ravel()
    C = bus.size
    return sp.csr_matrix((np.ones(C, dtype=np.float32), (bus, np.arange(C))),
                         shape=(ny * nx, C))


def pair_apart(matrix, ny, nx):
    """region_matrix's rows reordered so that the row blocks of half a
    region row (nx / 2 buses each) come in pairs of region rows iy and
    iy + ny / 2, which share no column block."""
    b = np.arange(ny * nx)
    iy, ix = b // nx, b % nx
    half, x = ix // (nx // 2), ix % (nx // 2)
    pos = half * ny + 2 * (iy % (ny // 2)) + iy // (ny // 2)
    new = np.empty_like(b)
    new[pos * (nx // 2) + x] = b
    return matrix[new]


def flat_args(args):
    """(flat fields, lat_cell, matrix, V, POWn) of the step's arguments, as
    the step hands them to the kernel."""
    fields, _, _, lat, V, POWn, matrix = args
    T, Y, X = fields["wnd100m"].shape
    flat = {k: fields[k].reshape(T, Y * X) for k in FIELD_ORDER}
    return flat, lat.repeat_interleave(X), matrix, V, POWn


def run_both(args):
    """(kernel, plain) outputs of the fused step on one set of arguments."""
    flat, lat_cell, matrix, V, POWn = flat_args(args)
    got = wind_pv_bus_megakernel(flat, lat_cell, matrix, V, POWn, PANEL, HUB_HEIGHT)
    want = wind_pv_bus_plain(flat, lat_cell, matrix, V, POWn, PANEL, HUB_HEIGHT)
    torch.cuda.synchronize()
    return got, want


def continental_inputs():
    """Phase 9: the continental Cutout and region matrix."""
    t0 = time.perf_counter()
    cut = Cutout(module="synthetic", x=slice(-12, 18 + CONT_DX / 2),
                 y=slice(35, 60 + CONT_DY / 2), dx=CONT_DX, dy=CONT_DY, time=CONT_TIME)
    cut.prepare(features=["wind", "influx", "temperature"])
    T, (Y, X) = len(cut.grid_desc.time), cut.shape
    C = Y * X
    log(f"continental inputs: T={T} Y={Y} X={X} (C={C}), {len(cut.data)} variables, "
        f"prepared on the host in {time.perf_counter() - t0:.2f} s")
    if (T, Y, X) != CONT_SHAPE:
        raise RuntimeError(f"continental grid {(T, Y, X)}, want {CONT_SHAPE}")
    log(f"  cut: T={T} h (two {CHUNK} h chunks) of the full year's 8760 h, "
        f"{T * C / 1e6:.1f}M of {8760 * C / 1e6:.1f}M cell-hours, to keep the phase "
        "within the smoke's time (host synthesis alone grows with T)")
    matrix = region_matrix(cut, *CONT_REGIONS)
    B = matrix.shape[0]
    bsr = to_bsr(matrix)
    nb, W = banded_width(matrix)
    # spmm_closure's routing rule
    route = ("dense" if B * C <= aggregate._DENSE_LIMIT else
             "banded" if nb * 128 * W <= B * C // 2 else "chunked")
    log(f"  matrix ({B}, {C}), {matrix.nnz} entries: B*C = {B * C / 1e6:.1f}M "
        f"= {B * C / aggregate._DENSE_LIMIT:.2f} x the dense limit; banded nb={nb} "
        f"W={W} ({nb * 128 * W / 1e6:.1f}M band entries); to_bsr(32, 512) K="
        f"{len(bsr['row_blk'])} ({len(bsr['row_blk']) * 32 * 512 / (B * bsr['C_pad']):.2%} "
        f"of the blocks); route {route}")
    if route != "banded":
        raise RuntimeError(f"the continental matrix takes the {route} route, not banded")
    return cut, matrix


def continental_path(cut, matrix, card):
    """Phase 10: wind and PV resident, streamed raw and streamed packed;
    returns the resident wind capacity factors of the first CHUNK hours
    as a (CHUNK, C) tensor on the card."""
    T, (Y, X) = len(cut.grid_desc.time), cut.shape
    C, B = Y * X, matrix.shape[0]
    runs = {
        "wind": lambda **k: cut.wind(turbine="Vestas_V112_3MW", matrix=matrix,
                                     aggregate_time=None, **k),
        "pv": lambda **k: cut.pv(panel="CSi", orientation="latitude_optimal", matrix=matrix,
                                 aggregate_time=None, **k),
    }
    modes = {"resident": dict(time_chunk=0), "streamed raw": dict(time_chunk=CHUNK),
             "streamed int16": dict(time_chunk=CHUNK, stream_pack="int16")}
    log(f"continental path on {card}:")
    t0 = time.perf_counter()
    fields = cut.fields()
    torch.cuda.synchronize()
    log(f"  resident staging: {len(fields)} fields on the card in "
        f"{time.perf_counter() - t0:.2f} s (set-up of the resident mode)")
    if not all(t.is_cuda for t in fields.values()):
        raise RuntimeError("the resident fields are not on the card")
    nb, W = banded_width(matrix)
    band_flops = 2 * nb * 128 * W * CHUNK
    windows = [(t, t + CHUNK) for t in range(0, T, CHUNK)]
    # set-up: the streamer keeps two pinned buffers on the Cutout, sized by
    # the largest chunk so far; a streamed raw PV call sizes them for all
    # the runs below, so that none of them times the allocation
    with profiled() as prof:
        t0 = time.perf_counter()
        runs["pv"](**modes["streamed raw"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    pin = sum(c.get("pin", 0.0) for c in chunk_steps(prof)[0].values())
    log(f"  streamer set-up: a first streamed raw PV call, {wall:.3f} s, of which {pin:.1f} ms "
        "allocating the two pinned buffers that the runs below reuse")
    out = {}
    for mode, kw in modes.items():
        for name, fn in runs.items():
            wind_pv_bus_megakernel.launches = bsr_spmm_kernel.launches = 0
            torch.cuda.synchronize()
            with profiled() as prof:
                t0 = time.perf_counter()
                res = fn(**kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            vals = np.asarray(res.values)
            if vals.shape != (B, T) or not np.isfinite(vals).all():
                raise RuntimeError(f"{name} {mode}: {vals.shape}, finite "
                                   f"{np.isfinite(vals).all()}, want ({B}, {T})")
            # staged: every chunk ran each step's range (host records, always
            # kept) and packed on the host, and the trace holds a pinned
            # transfer, which only the streamer's side stream makes
            chunks, n_copies = chunk_steps(prof)
            staged = list(chunks) == windows and n_copies >= 1 and all(
                {"pack", "copy", "convert", "aggregate"} <= set(c) and c["pack"] > 0
                for c in chunks.values())
            if kw["time_chunk"] and not staged:
                raise RuntimeError(f"{name} {mode}: chunks not staged through the card's "
                                   f"copy stream ({n_copies} pinned transfers): {chunks}")
            lost = sum(c[k] == 0 for c in chunks.values() for k in ("copy", "convert", "aggregate"))
            idle = device_idle(prof, wall * 1e3)
            log(f"  {name} {mode}: {wall:.3f} s = {T * C / wall:.4g} cell-hours/s "
                f"(host work included{', under torch.profiler' if idle else ''}); "
                f"kernel launches {wind_pv_bus_megakernel.launches + bsr_spmm_kernel.launches}"
                + ("" if idle is None else
                   f"; device busy {idle[0]:.1f} ms, idle share {idle[1]:.3f}")
                + (f"; {n_copies} pinned transfers in the trace, {lost} step(s) of the "
                   "split not in it" if kw["time_chunk"] else ""))
            for (c0, c1), c in chunks.items():
                pin = c.get("pin", 0.0)
                log(f"    chunk [{c0}, {c1}): pack {c['pack'] - pin:.1f} ms"
                    + (f" (and {pin:.1f} ms allocating the pinned buffers)" if pin else "")
                    + f", copy {step_ms(c['copy'], '.2f')}, convert "
                    f"{step_ms(c['convert'], '.2f')}, banded aggregation "
                    f"{step_ms(c['aggregate'], '.3f')} (bound "
                    f"{band_flops / FP32_FLOPS * 1e3:.3f} ms: {band_flops / 1e9:.2f} GFLOP)")
            out[name, mode] = vals

    for name in runs:
        res = out[name, "resident"]
        scale = float(np.abs(res).max())
        raw = float(np.abs(out[name, "streamed raw"] - res).max())
        diff = np.abs(out[name, "streamed int16"] - res)
        log(f"  {name}: streamed raw vs resident max {raw:.3e}; int16 vs resident max "
            f"{diff.max():.3e}, p999 {np.quantile(diff, 0.999):.3e} (max |resident| {scale:.4g})")
        if not raw <= REL_TOL * scale:
            raise RuntimeError(f"{name}: streamed raw differs from resident by {raw}")
        bounds = ((diff.max(), 3e-3),) if name == "wind" else \
            ((np.quantile(diff, 0.999), 3e-3), (diff.max(), 2e-2))
        for got, rel in bounds:
            if not got < rel * scale:
                raise RuntimeError(f"{name}: int16 vs resident {got} above {rel} * {scale}")

    log("  first 48 h against the plain path on the CPU:")
    sub = cut.isel_time(0, 48)
    cpu = Cutout(data=sub.data, grid_desc=sub.grid_desc, attrs=sub.attrs,
                 var_attrs=sub.var_attrs, device="cpu")
    cpu_runs = {
        "wind": cpu.wind(turbine="Vestas_V112_3MW", matrix=matrix, aggregate_time=None),
        "pv": cpu.pv(panel="CSi", orientation="latitude_optimal", matrix=matrix,
                     aggregate_time=None),
    }
    for name, res in cpu_runs.items():
        want = np.asarray(res.values)
        diff = np.abs(out[name, "resident"][:, :48] - want)
        scale = float(np.abs(want).max())
        above = int((diff > REL_TOL * scale).sum())
        log(f"    {name}: max {diff.max():.3e}, p999 {np.quantile(diff, 0.999):.3e}, "
            f"{above} of {diff.size} entries above {REL_TOL} * max (max |CPU| {scale:.4g})")
        bounds = ((diff.max(), REL_TOL),) if name == "wind" else \
            ((np.quantile(diff, 0.999), REL_TOL), (diff.max(), 2e-2))
        for got, rel in bounds:
            if not got <= rel * scale:
                raise RuntimeError(f"{name}: card vs CPU {got} above {rel} * {scale}")

    turbine = get_windturbineconfig("Vestas_V112_3MW", add_cutout_windspeed=False)
    cf = convert_wind(cut, turbine).values[:CHUNK].reshape(CHUNK, C).contiguous()
    return cf


def bsr_phase(matrix, cf, card, ptxas):
    """Phase 11: the BSR entry on the card; returns its kernels entry."""
    T, C = cf.shape
    B = matrix.shape[0]
    bsr = to_bsr(matrix)
    t0 = time.perf_counter()
    staged = stage_bsr(bsr, cf.device)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    cp = staged["compact"]
    K, bb, bc = len(bsr["row_blk"]), bsr["block_b"], bsr["block_c"]
    nnz = int(np.count_nonzero(bsr["blocks"]))
    log(f"BSR entry: T={T} C={C} B={B}, K={K} blocks of {bb} x {bc}:")
    log(f"  set-up: stage_bsr {stage_s:.3f} s, the host's compact form and the upload "
        f"({cp['unit_col'].numel()} units of {cp['rows']} rows, {cp['ell'].shape[0]} entry "
        f"slots for {nnz} nonzeros)")
    wind_pv_bus_megakernel.launches = bsr_spmm_kernel.launches = 0
    got = bsr_spmm_kernel(staged, cf)
    torch.cuda.synchronize()
    launches = bsr_spmm_kernel.launches
    log(f"  entry path: {launches} launches of bsr_spmm_kernel, "
        f"{wind_pv_bus_megakernel.launches} of wind_pv_bus_megakernel")
    if launches < 1:
        raise RuntimeError("the BSR entry did not launch its kernel")
    if tuple(got.shape) != (T, B) or not torch.isfinite(got).all():
        raise RuntimeError(f"BSR entry: {tuple(got.shape)}, finite {bool(torch.isfinite(got).all())}")
    plain = bsr_spmm(staged, cf)
    err = compare("wind capacity factors, kernel vs plain", got, plain)
    if not torch.equal(bsr_spmm_kernel(staged, cf), got):
        raise RuntimeError("a second call gave other bits")
    log("  a second call repeats the bits")

    rng = np.random.default_rng(5)
    nan_cf = cf.clone()
    nan_cf[torch.as_tensor(rng.integers(0, T, 6)), torch.as_tensor(rng.integers(0, C, 6))] = \
        float("nan")
    err = max(err, compare("NaN cells (dense-in-block rule)",
                           bsr_spmm_kernel(staged, nan_cf), bsr_spmm(staged, nan_cf)))
    # a NaN at a stored zero of a row that has nonzeros elsewhere in the block
    blk0 = np.asarray(bsr["blocks"][0])
    r = int(np.flatnonzero((blk0 != 0).any(axis=1))[0])
    c = int(np.flatnonzero(blk0[r] == 0)[0])
    zero_cf = cf.clone()
    zero_cf[T // 2, int(bsr["col_blk"][0]) * bc + c] = float("nan")
    k_out = bsr_spmm_kernel(staged, zero_cf)
    b = int(bsr["row_blk"][0]) * bb + r
    if not bool(torch.isnan(k_out[T // 2, b])):
        raise RuntimeError("a NaN at a stored zero did not reach its row")
    err = max(err, compare("a NaN at a stored zero of a row with nonzeros", k_out,
                           bsr_spmm(staged, zero_cf)))
    # +Inf and -Inf cells; in this matrix each column holds one nonzero, so
    # at each such cell one row of the block meets it at a nonzero (+-Inf
    # when nothing else is non-finite in its blocks that hour) and the
    # others at zeros (NaN)
    inf_cf = cf.clone()
    hours = torch.as_tensor(rng.choice(T, 8, replace=False))
    inf_cf[hours[:4], torch.as_tensor(rng.integers(0, C, 4))] = float("inf")
    inf_cf[hours[4:], torch.as_tensor(rng.integers(0, C, 4))] = -float("inf")
    k_out = bsr_spmm_kernel(staged, inf_cf)
    err = max(err, compare("+Inf and -Inf cells", k_out, bsr_spmm(staged, inf_cf)))
    n_pos, n_neg = int((k_out == float("inf")).sum()), int((k_out == -float("inf")).sum())
    if not (n_pos and n_neg):
        raise RuntimeError(f"+-Inf cells gave {n_pos} +Inf and {n_neg} -Inf outputs")
    log(f"  +-Inf cells: {n_pos} +Inf, {n_neg} -Inf and {int(torch.isnan(k_out).sum())} NaN "
        "outputs, identical to the plain version")
    empty = matrix.tolil()
    empty[bb:2 * bb] = 0.0
    ebsr = stage_bsr(to_bsr(empty.tocsr()), cf.device)
    eout = bsr_spmm_kernel(ebsr, cf)
    if not torch.equal(eout[:, bb:2 * bb], torch.zeros_like(eout[:, bb:2 * bb])):
        raise RuntimeError("the empty row block is not exactly zero")
    err = max(err, compare("empty row block", eout, bsr_spmm(ebsr, cf)))
    for rT, rC, rB in BSR_RAGGED:
        m = sp.random(rB, rC, density=0.02, random_state=rT, format="csr", dtype=np.float32)
        f = torch.as_tensor(rng.random((rT, rC), dtype=np.float32))
        rb = to_bsr(m, block_b=8, block_c=256)
        k_out = bsr_spmm_kernel(rb, f.cuda())
        err = max(err, compare(f"ragged {(rT, rC, rB)} vs card plain", k_out,
                               bsr_spmm(rb, f.cuda())),
                  compare(f"ragged {(rT, rC, rB)} vs CPU plain", k_out, bsr_spmm(rb, f)))
    # the same matrix with its row blocks paired so that no super row's two
    # row blocks share a column block: super rows merge no unit
    apart = stage_bsr(to_bsr(pair_apart(matrix, *CONT_REGIONS)), cf.device)
    err = max(err, compare("row blocks paired apart", bsr_spmm_kernel(apart, cf),
                           bsr_spmm(apart, cf)))

    kernel_ms = cuda_ms(lambda: bsr_spmm_kernel(staged, cf), reps=20)
    apart_ms = cuda_ms(lambda: bsr_spmm_kernel(apart, cf), reps=20)
    del apart
    plain_ms = cuda_ms(lambda: bsr_spmm(staged, cf), reps=5, warmup=1)
    torch.backends.cuda.matmul.allow_tf32 = False
    dense = torch.as_tensor(matrix.toarray(), device=cf.device)
    library_ms = cuda_ms(lambda: cf @ dense.T, reps=5, warmup=1)
    lib_err = float((cf @ dense.T - got).abs().max())
    try:
        pad = bsr["C_pad"] - C
        a_bsr = torch.nn.functional.pad(dense, (0, pad)).to_sparse_bsr((bb, bc))
        rhs = torch.nn.functional.pad(cf, (0, pad)).T.contiguous()
        sparse_ms = cuda_ms(lambda: torch.sparse.mm(a_bsr, rhs), reps=5, warmup=1)
        sparse_note = f"{sparse_ms:.4f} ms"
    except (RuntimeError, NotImplementedError) as exc:
        sparse_ms, sparse_note = None, f"does not run here ({str(exc).splitlines()[0][:120]})"
    del dense
    # cuSPARSE through torch.sparse.mm on the matrix as CSR: from the
    # kernel's own (T, C) field (its transpose counted), and from a field
    # transposed beforehand
    csr = torch.sparse_csr_tensor(
        torch.as_tensor(matrix.indptr, dtype=torch.int64),
        torch.as_tensor(matrix.indices, dtype=torch.int64),
        torch.as_tensor(matrix.data, dtype=torch.float32), size=matrix.shape).to(cf.device)
    csr_ms = cuda_ms(lambda: torch.sparse.mm(csr, cf.T).T, reps=20)
    cf_t = cf.T.contiguous()
    csr_t_ms = cuda_ms(lambda: torch.sparse.mm(csr, cf_t), reps=20)
    csr_err = float((torch.sparse.mm(csr, cf.T).T - got).abs().max())
    del cf_t
    # the work the function needs: a product per nonzero entry in the
    # blocks (a stored zero only has to pass a NaN on, which a test of the
    # field does), each input the kernel takes read once (the field and the
    # compact form) and the output written once
    n_flops = 2 * nnz * T
    cp_bytes = sum(t.numel() * t.element_size() for t in cp.values() if torch.is_tensor(t))
    n_bytes = 4 * (C * T + T * B) + cp_bytes
    flops_ms, bytes_ms = n_flops / FP32_FLOPS * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(flops_ms, bytes_ms)
    log(f"  timing on {card}: kernel {kernel_ms:.4f} ms = {bound_ms / kernel_ms:.1%} of its bound "
        f"{bound_ms:.4f} ms ({nnz} nonzeros in the blocks, {nnz / (K * bb * bc):.2%} of their "
        f"entries: {n_flops / 1e9:.4f} GFLOP at 67 TFLOP/s: {flops_ms:.4f} ms; "
        f"{n_bytes / 1e9:.4f} GB at 3.35 TB/s: {bytes_ms:.4f} ms, of which the compact form "
        f"{cp_bytes / 1e6:.3f} MB); plain {plain_ms:.4f} ms; "
        f"dense torch.matmul (TF32 off, {2 * B * C * T / 1e9:.1f} GFLOP) {library_ms:.4f} ms, "
        f"max diff to the kernel {lib_err:.3e}; torch.sparse.mm on to_sparse_bsr({bb}, {bc}): "
        f"{sparse_note}")
    log(f"  row blocks paired apart (no unit merged): kernel {apart_ms:.4f} ms")
    log(f"  torch.sparse.mm on the CSR matrix (cuSPARSE): {csr_ms:.4f} ms from the (T, C) "
        f"field, its transpose counted; {csr_t_ms:.4f} ms from a field transposed beforehand; "
        f"max diff to the kernel {csr_err:.3e}")
    per_sm, smem = bsr_ops.occupancy(cf.device.index, cp["width"])
    regs, st, ld = ptxas["bsr_spmm"]["bsr_spmm_kernel"]
    log(f"  bsr_spmm_kernel: {regs} registers, {st} B spill stores, {ld} B spill loads, "
        f"{smem} B of shared memory, {per_sm} blocks = {per_sm * 8} warps an SM")
    return {
        "name": "bsr_spmm_kernel",
        "route": "cuda",
        "source": "atlite_tpu_torch/ops/csrc/bsr_spmm.cu",
        "replaces": "atlite_tpu/ops/bsr_spmm.py:337",
        "launches": launches,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
        "library_ms": library_ms,
        "csr_library_ms": csr_ms,
        "csr_pretransposed_ms": csr_t_ms,
        "sparse_bsr_ms": sparse_ms,
        "paired_apart_ms": apart_ms,
    }


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2

    # ---- 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    log(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(card, flush=True)

    # ---- 2. build
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s for {sorted(libs)}")
    ptxas = {}
    for name, path in libs.items():
        ptxas[name] = ptxas_summary(open(f"{path}.log", encoding="utf-8").read())
        for fn, (regs, st, ld) in ptxas[name].items():
            log(f"  {name}: {fn}: {regs} registers, {st} B spill stores, {ld} B spill loads")

    # ---- 3. inputs
    T, Y, X, B = BENCH_SHAPE
    t0 = time.perf_counter()
    host = build_inputs(T, Y, X, B)
    args = from_jax_inputs(*host, device="cuda")
    torch.cuda.synchronize()
    C = Y * X
    log(f"inputs: T={T} Y={Y} X={X} B={B}, {len(host[5])} knots, "
        f"{time.perf_counter() - t0:.2f} s")

    # ---- 4. main path: entry()'s step on the card
    step, example_args = entry()
    wind_pv_bus_megakernel.launches = 0
    ex_w, ex_p = step(*example_args)
    wind_bus, pv_bus = step(*args)
    torch.cuda.synchronize()
    launches = wind_pv_bus_megakernel.launches
    log(f"main path: {launches} launches of wind_pv_bus_megakernel")
    if launches < 1:
        raise RuntimeError("the main path did not launch the fused kernel")
    for name, out, shape in (("example wind", ex_w, (24, 4)), ("example pv", ex_p, (24, 4)),
                             ("wind_bus", wind_bus, (T, B)), ("pv_bus", pv_bus, (T, B))):
        if tuple(out.shape) != shape or out.device.type != "cuda":
            raise RuntimeError(f"{name}: {tuple(out.shape)} on {out.device}, want {shape}")
        if not torch.isfinite(out).all():
            raise RuntimeError(f"{name}: non-finite values")
    log(f"  wind_bus mean {float(wind_bus.mean()):.6g}, pv_bus mean {float(pv_bus.mean()):.6g}")
    again = wind_pv_bus_megakernel(*flat_args(args), PANEL, HUB_HEIGHT)
    if not (torch.equal(again[0], wind_bus) and torch.equal(again[1], pv_bus)):
        raise RuntimeError("a second call gave other bits: the sums are not in a fixed order")
    log("  a second call repeats both series bit for bit")

    # ---- 5. plain version on the card
    log("plain version on the card:")
    flat, lat_cell, matrix, V, POWn = flat_args(args)
    plain_w, plain_p = wind_pv_bus_plain(flat, lat_cell, matrix, V, POWn, PANEL, HUB_HEIGHT)
    err = max(compare("wind_bus", wind_bus, plain_w), compare("pv_bus", pv_bus, plain_p))
    (k_w, k_p), (r_w, r_p) = run_both(example_args)
    err = max(err, compare("example wind_bus", k_w, r_w), compare("example pv_bus", k_p, r_p))
    # roughness that changes every hour in every cell (as ERA5's does over
    # sea): each cell-hour takes its own hub factor
    gen = torch.Generator(device="cuda").manual_seed(1)
    rough_fields = dict(args[0])
    rough_fields["roughness"] = args[0]["roughness"] * torch.exp(
        0.5 * torch.randn((T, Y, X), generator=gen, device="cuda"))
    rough_args = (rough_fields,) + tuple(args[1:])
    (k_w, k_p), (r_w, r_p) = run_both(rough_args)
    err = max(err, compare("wind_bus, roughness varying by hour", k_w, r_w),
              compare("pv_bus, roughness varying by hour", k_p, r_p))

    # ---- 6. NaN cells
    log("NaN cells in wnd100m:")
    rng = np.random.default_rng(0)
    nan_fields = dict(args[0])
    wnd = nan_fields["wnd100m"].clone()
    ts, ys, xs = (torch.as_tensor(rng.integers(0, n, 8)) for n in (T, Y, X))
    wnd[ts, ys, xs] = float("nan")
    wnd[:, ys[0], xs[0]] = float("nan")  # one cell NaN at every hour
    nan_fields["wnd100m"] = wnd
    nan_args = (nan_fields,) + tuple(args[1:])
    (k_w, k_p), (r_w, r_p) = run_both(nan_args)
    touched = (torch.isnan(wnd.reshape(T, C)).float() @ (matrix != 0).float().T) > 0
    if not torch.equal(torch.isnan(k_w), touched):
        raise RuntimeError("kernel's wind NaN mask is not 'bus touches a NaN cell'")
    err = max(err, compare("wind_bus with NaN cells", k_w, r_w),
              compare("pv_bus with NaN cells", k_p, r_p))
    log(f"  {int(touched.sum())} NaN (hour, bus) entries of {T * B}, masks identical")

    # ---- 7. ragged shapes
    for shape in RAGGED_SHAPES:
        log(f"ragged shape T, Y, X, B = {shape}:")
        small = build_inputs(*shape)
        (k_w, k_p), (r_w, r_p) = run_both(from_jax_inputs(*small, device="cuda"))
        cpu_args = flat_args(from_jax_inputs(*small, device="cpu"))
        c_w, c_p = wind_pv_bus_plain(*cpu_args, PANEL, HUB_HEIGHT)
        err = max(err, compare("wind_bus vs card plain", k_w, r_w),
                  compare("pv_bus vs card plain", k_p, r_p),
                  compare("wind_bus vs CPU plain", k_w, c_w),
                  compare("pv_bus vs CPU plain", k_p, c_p))

    # ---- 8. timing
    K = V.shape[0]
    # in turns (A, B, C, C, B, A): the step; the same work with the knot
    # table built at every call, as without the step's copy; the step on
    # roughness varying by hour
    turns = {"step": lambda: step(*args),
             "table": lambda: wind_pv_bus_megakernel(*flat_args(args), PANEL, HUB_HEIGHT),
             "rough": lambda: step(*rough_args)}
    turn_ms = {k: [] for k in turns}
    for k in list(turns) + list(turns)[::-1]:
        turn_ms[k].append(cuda_ms(turns[k], reps=20))
    step_ms, table_ms, rough_ms = (sum(v) / len(v) for v in turn_ms.values())
    enqueue_ms = {}
    for k in ("step", "table"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            turns[k]()
        enqueue_ms[k] = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
    del turns, rough_args, rough_fields
    plain_ms = cuda_ms(lambda: wind_pv_bus_plain(flat, lat_cell, matrix, V, POWn, PANEL,
                                                 HUB_HEIGHT), reps=3, warmup=1)
    cf = torch.rand((T, C), device="cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    matmul_ms = cuda_ms(lambda: (cf @ matrix.T, cf @ matrix.T), reps=20)
    n_bytes = 4 * (9 * T * C + C + B * C + 2 * K + 2 * T * B)
    n_flops = T * C * (4 * B + PHYS_FLOPS)
    bytes_ms, flops_ms = n_bytes / HBM_BYTES_PER_S * 1e3, n_flops / FP32_FLOPS * 1e3
    bound_ms = max(bytes_ms, flops_ms)
    log(f"timing on {card}:")
    log(f"  fused step {step_ms:.4f} ms = {T * C / step_ms * 1e3:.4g} cell-hours/s; "
        f"bound {bound_ms:.4f} ms ({n_bytes / 1e9:.4f} GB at 3.35 TB/s: {bytes_ms:.4f} ms; "
        f"{n_flops / 1e9:.3f} GFLOP at 67 TFLOP/s: {flops_ms:.4f} ms)")
    log(f"  in turns, 20 calls each, two rounds: the step {turn_ms['step']}, with the knot table "
        f"built at every call {turn_ms['table']} (mean {table_ms:.4f} ms), with roughness "
        f"varying by hour {turn_ms['rough']} (mean {rough_ms:.4f} ms)")
    log(f"  the host enqueues a step in {enqueue_ms['step']:.4f} ms, with the table built at "
        f"every call in {enqueue_ms['table']:.4f} ms (perf_counter over 20 calls, no sync)")
    log(f"  plain version {plain_ms:.3f} ms; two torch.matmul aggregations alone "
        f"{matmul_ms:.4f} ms")
    kernel_ms = device_breakdown(lambda: step(*args))
    own_ms = None
    if kernel_ms:
        busy = sum(kernel_ms.values())
        log(f"  device time of the step by kernel (torch.profiler), {busy:.4f} ms busy, "
            f"idle share {max(0.0, 1 - busy / step_ms):.3f} of the event-timed step:")
        for name, ms in sorted(kernel_ms.items(), key=lambda kv: -kv[1]):
            log(f"    {ms:.4f} ms  {name[:90]}")
        own_ms = sum(ms for name, ms in kernel_ms.items() if "wind_pv_bus_kernel" in name)
        ours = sum(ms for name, ms in kernel_ms.items()
                   if re.search(r"wind_pv_bus_kernel|panel_kernel|sum_items_kernel", name))
        log(f"  the fused kernel alone: {own_ms:.4f} ms = {n_bytes / own_ms / 1e6:.1f} GB/s, "
            f"{bytes_ms / own_ms:.1%} of its byte bound ({bytes_ms:.4f} ms); the step: "
            f"{bytes_ms / step_ms:.1%}; PyTorch's small kernels of the step (the knot "
            f"table, the latitudes): {busy - ours:.4f} ms")
    else:
        log("  device time by kernel: not measured (the profiler recorded none)")
    for nb in (B, WIDE_B):
        per_sm, smem, tile = occupancy(torch.cuda.current_device(), nb)
        regs, st, ld = ptxas["megakernel"][f"wind_pv_bus_kernel<{tile // 4}>"]
        log(f"  B={nb}: wind_pv_bus_kernel<{tile // 4}> ({tile} buses a pass): {regs} registers, "
            f"{st} B spill stores, {ld} B spill loads, {smem} B of shared memory, "
            f"{per_sm} blocks = {per_sm * 8} warps an SM")

    # the step at B=256 over the same fields: the physics runs once a
    # cell-hour, whatever the bus count
    rng = np.random.default_rng(256)
    wide = rng.random((WIDE_B, C), dtype=np.float32)
    wide *= rng.random((WIDE_B, C)) < 0.05
    wide = torch.as_tensor(wide, device="cuda")
    log(f"B={WIDE_B} (the bench fields, a {WIDE_B}-bus matrix of density 0.05):")
    k_w, k_p = wind_pv_bus_megakernel(flat, lat_cell, wide, V, POWn, PANEL, HUB_HEIGHT)
    r_w, r_p = wind_pv_bus_plain(flat, lat_cell, wide, V, POWn, PANEL, HUB_HEIGHT)
    err = max(err, compare(f"wind_bus B={WIDE_B}", k_w, r_w),
              compare(f"pv_bus B={WIDE_B}", k_p, r_p))
    wide_ms = cuda_ms(lambda: wind_pv_bus_megakernel(flat, lat_cell, wide, V, POWn, PANEL,
                                                     HUB_HEIGHT), reps=10)
    agg_ms = 4 * T * C * WIDE_B / FP32_FLOPS * 1e3
    log(f"  fused step {wide_ms:.4f} ms at B={WIDE_B} against {step_ms:.4f} ms at B={B}; its "
        f"aggregation alone is {4 * T * C * WIDE_B / 1e9:.2f} GFLOP = {agg_ms:.4f} ms of FP32 "
        f"FMA at 67 TFLOP/s")
    del wide, k_w, k_p, r_w, r_p

    cut, matrix = continental_inputs()
    cf = continental_path(cut, matrix, card)
    bsr_entry = bsr_phase(matrix, cf, card, ptxas)

    kernels = [{
        "name": "wind_pv_bus_megakernel",
        "route": "cuda",
        "source": "atlite_tpu_torch/ops/csrc/megakernel.cu",
        "replaces": "atlite_tpu/ops/megakernel.py:164",
        "launches": launches,
        "max_abs_err": err,
        "ms": step_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "library_ms": None,
        "kernel_ms": own_ms,
        "table_each_call_ms": table_ms,
        "hourly_roughness_ms": rough_ms,
        "enqueue_ms": enqueue_ms["step"],
        "matmul_only_ms": matmul_ms,
        "b256_ms": wide_ms,
    }, bsr_entry]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
