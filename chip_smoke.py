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
     is cut for time), prepared with wind, influx, temperature, runoff
     and height, and a (2048, C) region matrix (32 x 64 rectangles) that
     must take the banded route;
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
     blocks an SM;
 12. the other converters on the continental cut, each with the matrix:
     temperature, soil and dewpoint temperature, COP (air, soil), heat
     and cooling demand, Hay-Davies total irradiation, PV under each
     tracking mode, solar thermal, CSP (tower, trough) and smoothed
     runoff resident, and heat demand, soil COP and CSP also streamed raw
     and int16 in 720 h chunks; each conversion alone timed on the card
     by CUDA events (its output must lie on the card), each call under
     torch.profiler with its wall s, cell-hours/s, device busy ms and idle
     share (where the trace holds at least the conversion's device time),
     and the byte bound of the fields it reads; outputs finite of shape (2048, T) or
     (2048, days), streamed raw vs resident within 1e-5 * max, int16
     within phase 10's bounds, the first 48 h (two days) against the
     plain path on the CPU; then ``batched_line_rating`` (2048 lines of
     16 cells, 720 h) and ``shift_and_aggregate`` (500 plants, 20,000
     basin pairs, 1440 h) timed on the card against their CPU results;
 13. geometry on the continental cut: the 2048 regions of
     bench_continental.py as boxes, their indicator matrix by the C++
     engine (asserted built and loaded) and, on the first 256 regions, by
     numpy (the same matrix), with its entries and banded route;
     ``cutout.wind(..., shapes=regions, per_unit=True)`` and
     ``cutout.pv(..., layout=uniform_density_layout(...), shapes=regions)``
     resident under torch.profiler (wall s, busy ms, idle share), bit for
     bit against the same calls with the matrix, the first 48 h against
     the CPU; ``cutout.line_rating`` on 2048 five-point lines (intersection
     matrix host s, wall s, busy ms, idle share; first 48 h against a CPU
     cutout); ``cutout.hydro`` on a basin forest over the region boxes
     with 500 plants, both given as dicts of columns (wall s; against the
     CPU over the whole 1440 h); a second registry turbine, smoothed;
 14. the continental cut through an .atc store under build/ (refused
     unless the disk has twice the store's size free): ``to_file`` (wall
     s, GB/s, the sha256 timed apart), ``Cutout(path)`` (memory maps) and
     ``read_store(verify=True)`` timed; phase 10's calls from the
     reopened store, resident, streamed raw and int16, then streamed raw
     again after fsync and POSIX_FADV_DONTNEED of every file (the share of
     its pages in the page cache printed before and after), each with
     phase 10's split and idle share; every result equal to the in-memory
     cut's bit for bit; ``sel`` of a 64 x 64 box and ``merge`` of its wind
     and other variables ``equals`` the cut's arrays; the store removed;
 15. availability (land eligibility) through ``cutout.availabilitymatrix``
     on the card (the device path of gis/kernels.py), each case cold (a
     fresh excluder: the host layers' mask built per row block on a worker
     thread, packed upload, unpacked on the card; an aligned raster
     uploaded and sampled on the card) and warm (the host layers' mask
     cached on the card, an aligned raster sampled again), with its wall s, fine-pixel-shape Mpix/s, device busy ms and
     idle share (torch.profiler), the host's mask build ms a block, peak
     device memory, the shared host mask's bytes and the bound (an edge
     test per edge and window pixel, or the windows' and the matrix's
     bytes); the first 4 shapes against the host path
     within 2e-2: (a) bench.py's 12 boxes over a 0.01 deg land-use raster
     in EPSG:4326 (aligned: sampled on the card; the overlap products), (b) the same boxes over a
     100 m EPSG:3035 raster with a misaligned origin (a 32.5 Mpix
     lattice, the cross-CRS counts), (c)
     bench_continental.py's stage 5 on the continental cut: 40 boxes of
     3 x 3 deg over a 100 m EPSG:3035 raster (~806 Mpix); then ``regrid``
     of a week of the continental wind field, held on the card, onto 0.5
     and 0.125 deg (average, bilinear), host s, bit for bit the same call
     on a CPU cutout's field;
 16. multiple devices on the card: the mesh is every visible card repeated
     to 8 positions (``core/mesh.py``; the number of distinct cards is
     printed): (a) the headline step at the bench shape over meshes of 1,
     2, 4 and 8 positions (``entry.sharded_step_fn``: the fused kernel
     once a shard, the partial bus series summed over x), its launch count
     rising by the number of shards, the series against the unsharded
     step within 1e-5 * max with identical NaN masks (also with phase 6's
     NaN cells), CUDA-event ms of each beside the unsharded step's (on one
     card the cost of splitting, not a scaling result) and the host's
     enqueue ms a step; (b)
     ``halo_exchange`` values on an 8-way x mesh, and
     ``sharded_regrid_bilinear`` of 168 h of the continental wind onto
     0.125 deg on (t=2, x=4) against the serial ``regrid`` within 1e-6 *
     max, on the first 480 of the cut's 481 columns (481 divide by no x);
     (c) ``sharded_aggregate_banded`` of 720 h of that field, with NaN
     cells, by a (2048, C) region matrix on (t=2, x=4) against the
     unsharded banded route within 1e-5 * max, ms of both; (d)
     ``cut.shard(mesh)`` of 720 h of that cut, ``wind`` and ``pv`` with the
     matrix, resident, against the unsharded cut (first-call and repeat
     wall s, busy ms and idle share under torch.profiler), ``time_chunk``
     refused; (e) ``availabilitymatrix(..., mesh=)`` on phase 15's case
     (b) against no mesh within 1e-6; (f) two processes sharing the card
     over gloo (``core/comm.py``, ``core/multihost_worker.py``) on a small
     store under build/ (removed after): each reads half of the store's
     bytes and its results equal one process's; their exit codes;
 17. ERA5-format files through the port's codecs and ``prepare``: (a) from
     the continental cut's first 720 h (one monthly CDS request) the raw
     ERA5 variables whose derivations give its fields, written by the
     port's encoders under build/ (wind as GRIB1 16-bit simple packing,
     influx as the classic CDS NETCDF4: CF int16, zlib, latitude
     descending; temperature and runoff as GRIB2; height as one static
     GRIB1 message); (b) ``Cutout(path, module="era5", ...)`` and
     ``prepare`` feature by feature into an .atc store: decode MB/s (the
     decoder timed inside prepare), wall s a feature, the card's idle
     share (1: it is host work), peak host memory; (c) every decoded
     field within half a quantization step of what was encoded (the step
     worked out from each message's packing), NaN masks equal, y
     ascending, the store's variables equal the era5 derivations of the
     decoded arrays bit for bit; (d) ``wind``/``pv`` with phase 10's
     matrix from the reopened store on the card, resident and streamed
     int16: the first 48 h against the CPU within phase 10's bounds, int16
     against resident within phase 10's int16 bounds, resident against
     phase 10's series of the synthetic cut within a bound from the
     quantization (wind: an interval bound through the log law and the
     power curve, rigorous; PV: first order, doubled); (e) ``to_netcdf``
     of the prepared cutout (NETCDF4, zlib level 1, shuffle), s and GB/s,
     reopened from the .nc on the card: fields and the wind series equal
     (d)'s bit for bit; (f) a SARAH archive of SIS/SID NETCDF4 files
     (0.05 deg, 10 x 10 deg, a day of half hours, NaN gaps) prepared onto
     0.25 deg with the synthetic module's temperature and albedo, PV on
     the card against the CPU.  The files are removed after.  The
     streamed calls stage the whole span as one chunk;
 18. a full year on the card: (a) tests/test_fullyear.py's gates on a
     float64 synthetic 2013 (24 x 32 cells): the annual wind and PV
     capacity factors, the 365 heat-demand days and their sum, runoff
     normalized to a yearly total (through ``yearly_groups``) as pinned
     literals within rtol 1e-6, and twelve monthly means in (0, 1); (b) a
     float32 year at the bench grid (96 x 128 cells of 0.25 deg, 8760 h)
     with a (20, C) region matrix: an ``oedb:`` turbine found through a
     stub ``requests`` (nothing sent out) in a library whose row holds the
     registry's Vestas V112 3MW in kW, its series equal the registry
     turbine's bit for bit, resident and streamed int16 a month at a time;
     PV, heat demand and normalized runoff resident and streamed int16
     (wall s, cell-hours/s and idle share a call, pack / copy / convert /
     aggregate ms a chunk, the streamer's copy count as the staging
     gate), int16 within phase 10's bounds, the first 48 h against the
     CPU; the fused step at T = 8760 with the OEDB curve against its
     plain version within 1e-5 * max, its ms beside its byte bound; the
     peak host memory of the preparation; (c) every examples_torch/*.py
     in a subprocess on the card (rc 0 and output; one that stops only
     for want of matplotlib is reported as not run); (d) the fused kernel
     alone (its device time, torch.profiler) and the whole call (CUDA
     events) at the bench fields (T = 2184, C = 12,288, every row 16-byte
     aligned) and at their first 12,255 cells (rows at every 16-byte
     phase, as PyPSA-Eur's 23,711), B = 20 and 34, each against its plain
     version, with the launches counted by ``staged16``.
The step of phase 4 is also held against the JAX package's step on the
same inputs, stored by tools/make_jax_step_reference.py (within 1e-4 *
max; the diff is printed on the kernels line).
Then one JSON line of the converters, one of availability, one of the
multi-device phase, one of ingest, one of the year, one of kernels and,
last, the result line.
"""

from __future__ import annotations

import ctypes
import dataclasses
import gc
import json
import mmap
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import torch
from torch.autograd import DeviceType

from atlite_tpu_torch import (
    Cutout,
    DataArray,
    ExclusionContainer,
    aggregate,
    build_inputs,
    entry,
    from_jax_inputs,
    native,
    regrid,
)
from atlite_tpu_torch import profiling, resource
from atlite_tpu_torch import convert as conv
from atlite_tpu_torch.convert import convert_wind
from atlite_tpu_torch.core import store
from atlite_tpu_torch.core.grid import Affine
from atlite_tpu_torch.datasets import era5 as era5_module
from atlite_tpu_torch.datasets import synthetic
from atlite_tpu_torch.core.mesh import (
    NamedSharding,
    P,
    field_spec,
    halo_exchange,
    make_mesh,
    map_shards,
    put_global,
    shard_fields,
    sharded_aggregate_banded,
    sharded_regrid_bilinear,
)
from atlite_tpu_torch.entry import HUB_HEIGHT, PANEL, _dryrun_multiprocess, sharded_step_fn, step_fn
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
from atlite_tpu_torch.gis import kernels as avail_kernels
from atlite_tpu_torch.gis.crs import transform_points
from atlite_tpu_torch.gis.geometry import LineString, box
from atlite_tpu_torch.gis.raster import Raster
from atlite_tpu_torch.io import grib
from atlite_tpu_torch.io import netcdf as ncio
from atlite_tpu_torch.physics import hydro as hydro_physics
from atlite_tpu_torch.physics import line_rating as line_rating_physics
from atlite_tpu_torch.physics import wind as wind_physics
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
PTXAS_ENTRY = re.compile(
    r"Compiling entry function '_Z\w*?\d+([a-z][a-z_]*_kernel)(?:ILi(\d+)E(?:Lb([01])E)?)?")
PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_summary(text):
    """{kernel name (with its template arguments, as "<9, true>"):
    (registers, spill store bytes, spill load bytes)} from a build log of
    nvcc -Xptxas -v."""
    out, name, spill = {}, None, (0, 0)
    for line in text.splitlines():
        if m := PTXAS_ENTRY.search(line):
            args = [a for a in (m.group(2), {"1": "true", "0": "false"}.get(m.group(3))) if a]
            name = m.group(1) + (f"<{', '.join(args)}>" if args else "")
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


JAX_STEP_REFERENCE = (Path(__file__).resolve().parent / "tests" / "data_torch"
                      / "jax_step_bench.npz")
JAX_TOL = 1e-4  # the card's step against the stored JAX step, relative to max


def against_jax_step(wind_bus, pv_bus):
    """Max abs diff of the card's step at the bench shape against the JAX
    package's step on the same inputs (``__graft_entry__._step_fn`` on a
    CPU, float32, stored by tools/make_jax_step_reference.py); raises above
    JAX_TOL * max.  Returns {"wind_bus": diff, "pv_bus": diff}."""
    ref = np.load(JAX_STEP_REFERENCE)
    if tuple(ref["shape"]) != BENCH_SHAPE:
        raise RuntimeError(f"the stored JAX step is of shape {tuple(ref['shape'])}")
    out = {}
    for name, got in (("wind_bus", wind_bus), ("pv_bus", pv_bus)):
        want = ref[name].astype(np.float64)
        diff = float(np.abs(got.double().cpu().numpy() - want).max())
        scale = float(np.abs(want).max())
        log(f"  {name} against the JAX step (stored, {JAX_STEP_REFERENCE.name}): max abs diff "
            f"{diff:.3e} = {diff / scale:.3e} of max {scale:.4g}")
        if not diff <= JAX_TOL * scale:
            raise RuntimeError(f"{name}: the card's step differs from JAX's by {diff}")
        out[name] = diff
    return out


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
    # the call's own ranges (its matrix composition and per-unit scaling,
    # 0:T) hold every chunk and are no chunk of their own
    whole = (min(k[0] for k in out), max(k[1] for k in out)) if out else None
    if len(out) > 1 and whole in out:
        del out[whole]
    if len(copies) == len(out):
        for steps, (_, ms) in zip(out.values(), sorted(copies)):
            steps["copy"] = ms
    return out, len(copies)


def staging_gate(label, chunks, windows):
    """Raise unless a streamed call staged every chunk through the card's
    copy stream: each window ran each step's range (host records, always
    kept) and packed on the host, and the streamer counted one copy to
    the card a chunk (``Cutout._stream_copies``, reset before the call;
    the trace may drop a transfer, the count does not)."""
    copies = Cutout._stream_copies
    staged = list(chunks) == windows and copies == len(windows) and all(
        {"pack", "copy", "convert", "aggregate"} <= set(c) and c["pack"] > 0
        for c in chunks.values())
    if not staged:
        raise RuntimeError(f"{label}: chunks not staged through the card's copy stream "
                           f"({copies} copies counted for {len(windows)} chunks): {chunks}")


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


def aggregation_route(matrix):
    """(nb, W, route) of a (B, C) matrix by spmm_closure's routing rule."""
    B, C = matrix.shape
    nb, W = banded_width(matrix)
    route = ("dense" if B * C <= aggregate._DENSE_LIMIT else
             "banded" if nb * 128 * W <= B * C // 2 else "chunked")
    return nb, W, route


def continental_kw(time):
    """The continental grid's Cutout arguments over ``time``."""
    return dict(x=slice(-12, 18 + CONT_DX / 2), y=slice(35, 60 + CONT_DY / 2), dx=CONT_DX,
                dy=CONT_DY, time=time)


def continental_inputs():
    """Phase 9: the continental Cutout and region matrix."""
    t0 = time.perf_counter()
    cut = Cutout(module="synthetic", **continental_kw(CONT_TIME))
    cut.prepare(features=["wind", "influx", "temperature", "runoff", "height"])
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
    nb, W, route = aggregation_route(matrix)
    log(f"  matrix ({B}, {C}), {matrix.nnz} entries: B*C = {B * C / 1e6:.1f}M "
        f"= {B * C / aggregate._DENSE_LIMIT:.2f} x the dense limit; banded nb={nb} "
        f"W={W} ({nb * 128 * W / 1e6:.1f}M band entries); to_bsr(32, 512) K="
        f"{len(bsr['row_blk'])} ({len(bsr['row_blk']) * 32 * 512 / (B * bsr['C_pad']):.2%} "
        f"of the blocks); route {route}")
    if route != "banded":
        raise RuntimeError(f"the continental matrix takes the {route} route, not banded")
    return cut, matrix


def timed_mode(name, mode, fn, kw, shape, windows, band_flops):
    """One continental call ``fn(**kw)`` under torch.profiler: its wall s,
    cell-hours/s, idle share and, streamed, the per-chunk split (pack and
    pinned-buffer ms on the host, copy, convert and banded aggregation on
    the card); raises unless the (B, T) result is finite and every chunk
    was staged through the copy stream.  Returns {"vals", "wall", "idle",
    "chunks"}."""
    B, T, C = shape
    wind_pv_bus_megakernel.launches = bsr_spmm_kernel.launches = 0
    Cutout._stream_copies = 0
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
    chunks, n_copies = chunk_steps(prof)
    if kw.get("time_chunk"):
        staging_gate(f"{name} {mode}", chunks, windows)
    lost = sum(c[k] == 0 for c in chunks.values() for k in ("copy", "convert", "aggregate"))
    idle = device_idle(prof, wall * 1e3)
    log(f"  {name} {mode}: {wall:.3f} s = {T * C / wall:.4g} cell-hours/s "
        f"(host work included{', under torch.profiler' if idle else ''}); "
        f"kernel launches {wind_pv_bus_megakernel.launches + bsr_spmm_kernel.launches}"
        + ("" if idle is None else
           f"; device busy {idle[0]:.1f} ms, idle share {idle[1]:.3f}")
        + (f"; {Cutout._stream_copies} copies to the card counted by the streamer, {n_copies} "
           f"pinned transfers in the trace, {lost} step(s) of the "
           "split not in it" if kw.get("time_chunk") else ""))
    for (c0, c1), c in chunks.items():
        pin = c.get("pin", 0.0)
        log(f"    chunk [{c0}, {c1}): pack {c['pack'] - pin:.1f} ms"
            + (f" (and {pin:.1f} ms allocating the pinned buffers)" if pin else "")
            + f", copy {step_ms(c['copy'], '.2f')}, convert "
            f"{step_ms(c['convert'], '.2f')}, banded aggregation "
            f"{step_ms(c['aggregate'], '.3f')} (bound "
            f"{band_flops / FP32_FLOPS * 1e3:.3f} ms: {band_flops / 1e9:.2f} GFLOP)")
    return {"vals": vals, "wall": wall, "idle": idle, "chunks": chunks}


CONT_MODES = {"resident": dict(time_chunk=0), "streamed raw": dict(time_chunk=CHUNK),
              "streamed int16": dict(time_chunk=CHUNK, stream_pack="int16")}


def continental_runs(cut, matrix):
    """Phase 10's two calls, wind and PV with the matrix, on a cutout."""
    return {
        "wind": lambda **k: cut.wind(turbine="Vestas_V112_3MW", matrix=matrix,
                                     aggregate_time=None, **k),
        "pv": lambda **k: cut.pv(panel="CSi", orientation="latitude_optimal", matrix=matrix,
                                 aggregate_time=None, **k),
    }


def stage_all(cut):
    """``cut.fields()`` with every field staged on the card (the mapping
    stages each when first read), so that set-up holds the staging."""
    fields = cut.fields()
    list(fields.values())
    return fields


def continental_path(cut, matrix, card):
    """Phase 10: wind and PV resident, streamed raw and streamed packed;
    returns the resident wind capacity factors of the first CHUNK hours
    as a (CHUNK, C) tensor on the card, and the (B, T) results by (name,
    mode)."""
    T, (Y, X) = len(cut.grid_desc.time), cut.shape
    C, B = Y * X, matrix.shape[0]
    runs, modes = continental_runs(cut, matrix), CONT_MODES
    log(f"continental path on {card}:")
    t0 = time.perf_counter()
    fields = stage_all(cut)
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
            out[name, mode] = timed_mode(name, mode, fn, kw, (B, T, C), windows,
                                         band_flops)["vals"]

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
    return cf, out


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


# phase 12: each converter as a user calls it (the Cutout method and its
# arguments) and as the conversion alone (the converter and the arguments
# the method hands it), which is timed on the card by itself; "solar" ones
# are held card vs CPU and int16 by phase 10's PV bounds
def _conv(name, method, kw, func, ckw, solar=False, streamed=False):
    return {"name": name, "method": method, "kw": kw, "func": func, "ckw": ckw,
            "solar": solar, "streamed": streamed}


COP = {"sink_T": 55.0, "c0": None, "c1": None, "c2": None}
DEMAND = {"a": 1.0, "constant": 0.0, "hour_shift": 0.0}
CONVERTERS = [
    _conv("temperature", "temperature", {}, conv.convert_temperature, {}),
    _conv("soil_temperature", "soil_temperature", {}, conv.convert_soil_temperature, {}),
    _conv("dewpoint_temperature", "dewpoint_temperature", {},
          conv.convert_dewpoint_temperature, {}),
    _conv("cop_air", "coefficient_of_performance", {"source": "air"},
          conv.convert_coefficient_of_performance, {"source": "air", **COP}),
    _conv("cop_soil", "coefficient_of_performance", {"source": "soil"},
          conv.convert_coefficient_of_performance, {"source": "soil", **COP}, streamed=True),
    _conv("heat_demand", "heat_demand", {}, conv.convert_heat_demand,
          {"threshold": 15.0, **DEMAND}, streamed=True),
    _conv("cooling_demand", "cooling_demand", {"threshold": -5.0}, conv.convert_cooling_demand,
          {"threshold": -5.0, **DEMAND}),
    _conv("irradiation_hay_davies", "irradiation",
          {"orientation": "latitude_optimal", "trigon_model": "hay_davies"},
          conv.convert_irradiation, {"orientation": "latitude_optimal",
                                     "trigon_model": "hay_davies", "clearsky_model": None},
          solar=True),
] + [_conv(f"pv_{tr}", "pv", {"panel": "CSi", "orientation": "latitude_optimal", "tracking": tr},
           conv.convert_pv, {"panel": "CSi", "orientation": "latitude_optimal", "tracking": tr,
                             "clearsky_model": None}, solar=True)
     for tr in ("horizontal", "tilted_horizontal", "vertical", "dual")] + [
    _conv("solar_thermal", "solar_thermal", {}, conv.convert_solar_thermal,
          {"orientation": {"slope": 45.0, "azimuth": 180.0}, "trigon_model": "simple",
           "clearsky_model": "simple", "c0": 0.8, "c1": 3.0, "t_store": 80.0}, solar=True),
    _conv("csp_tower", "csp", {"installation": "SAM_solar_tower"}, conv.convert_csp,
          {"installation": "SAM_solar_tower"}, solar=True, streamed=True),
    _conv("csp_trough", "csp", {"installation": "SAM_parabolic_trough"}, conv.convert_csp,
          {"installation": "SAM_parabolic_trough"}, solar=True),
    _conv("runoff_smoothed", "runoff", {"smooth": True}, conv.convert_runoff,
          {"weight_with_height": True}),
]
LR_SHAPE = (2048, 16, 720)  # lines, cells a line, hours
HYDRO_SHAPE = (500, 40, 200)  # plants, upstream basins a plant, largest shift (h)


def field_bytes(cut, convert_func, kw, out_elems):
    """Bytes of the stored fields a converter reads (each once) and of
    its float32 (bus, time) output."""
    names = conv._streaming_vars(cut, convert_func, kw)
    names = set(cut.data) if names is None else names & set(cut.data)
    return sum(np.asarray(cut.data[n]).nbytes for n in names) + 4 * out_elems, sorted(names)


def converters_phase(cut, matrix, card):
    """Phase 12: the converters beyond wind and PV on the continental cut;
    returns their JSON entries and the resident runoff (B, T) series."""
    T, (Y, X) = len(cut.grid_desc.time), cut.shape
    C, B = Y * X, matrix.shape[0]
    days = T // 24
    modes = {"resident": {}, "streamed raw": dict(time_chunk=CHUNK),
             "streamed int16": dict(time_chunk=CHUNK, stream_pack="int16")}
    log(f"converters on {card} (T={T} h, {days} days, C={C}, the ({B}, C) banded matrix):")
    entries, out = [], {}
    for c in CONVERTERS:
        name, method, kw = c["name"], c["method"], c["kw"]
        n_out = days if method in ("heat_demand", "cooling_demand") else T
        n_bytes, names = field_bytes(cut, c["func"], c["ckw"], B * n_out)
        bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        # the conversion alone on the card (no aggregation, no host work):
        # CUDA events over three calls; its output must lie on the card
        ckw = dict(c["ckw"])
        if method == "pv":
            ckw["panel"] = conv.get_solarpanelconfig(ckw["panel"])
        if method == "csp":
            ckw["installation"] = conv.get_cspinstallationconfig(ckw["installation"])
        if not c["func"](cut, **ckw).values.is_cuda:
            raise RuntimeError(f"{name}: the conversion did not run on the card")
        conv_ms = cuda_ms(lambda: c["func"](cut, **ckw), reps=3, warmup=1)
        for mode in modes if c["streamed"] else ("resident",):
            wind_pv_bus_megakernel.launches = bsr_spmm_kernel.launches = 0
            torch.cuda.synchronize()
            with profiled() as prof:
                t0 = time.perf_counter()
                res = getattr(cut, method)(matrix=matrix, aggregate_time=None, **kw,
                                           **modes[mode])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            launches = wind_pv_bus_megakernel.launches + bsr_spmm_kernel.launches
            vals = np.asarray(res.values)
            if vals.shape != (B, n_out) or not np.isfinite(vals).all():
                raise RuntimeError(f"{name} {mode}: {vals.shape}, finite "
                                   f"{np.isfinite(vals).all()}, want ({B}, {n_out})")
            # the trace drops device records now and then: its busy time and
            # idle share stand only where it holds at least the conversion's
            idle = device_idle(prof, wall * 1e3)
            whole = idle is not None and idle[0] >= 0.9 * conv_ms
            trace = (f"device busy {idle[0]:.1f} ms, idle share {idle[1]:.3f}" if whole else
                     f"the trace dropped device records ({0 if idle is None else idle[0]:.1f} "
                     "ms of device time in it): idle share not measured")
            log(f"  {name} {mode}: {wall:.3f} s = {T * C / wall:.4g} cell-hours/s (host work "
                f"included, under torch.profiler); conversion alone {conv_ms:.2f} ms on the "
                f"card (CUDA events); {trace}; byte bound of the fields it reads and its output "
                f"{bound_ms:.3f} ms ({n_bytes / 1e9:.3f} GB at 3.35 TB/s: {', '.join(names)}); "
                f"kernel launches {launches}")
            entries.append({"name": name, "mode": mode, "wall_s": wall,
                            "cell_hours_per_s": T * C / wall, "convert_ms": conv_ms,
                            "busy_ms": idle[0] if whole else None,
                            "idle_share": idle[1] if whole else None, "bound_ms": bound_ms,
                            "bytes": n_bytes})
            out[name, mode] = vals

        res = out[name, "resident"]
        scale = float(np.abs(res).max())
        if c["streamed"]:
            raw = float(np.abs(out[name, "streamed raw"] - res).max())
            diff = np.abs(out[name, "streamed int16"] - res)
            log(f"    streamed raw vs resident max {raw:.3e}; int16 vs resident max "
                f"{diff.max():.3e}, p999 {np.quantile(diff, 0.999):.3e} (max |resident| "
                f"{scale:.4g})")
            if not raw <= REL_TOL * scale:
                raise RuntimeError(f"{name}: streamed raw differs from resident by {raw}")
            bounds = ((np.quantile(diff, 0.999), 3e-3), (diff.max(), 2e-2)) if c["solar"] \
                else ((diff.max(), 3e-3),)
            for got, rel in bounds:
                if not got < rel * scale:
                    raise RuntimeError(f"{name}: int16 vs resident {got} above {rel} * {scale}")

    log("  first 48 h (two days for the demands) against the plain path on the CPU:")
    sub = cut.isel_time(0, 48)
    cpu = Cutout(data=sub.data, grid_desc=sub.grid_desc, attrs=sub.attrs,
                 var_attrs=sub.var_attrs, device="cpu")
    t0 = time.perf_counter()
    for c in CONVERTERS:
        name = c["name"]
        want = np.asarray(getattr(cpu, c["method"])(matrix=matrix, aggregate_time=None,
                                                    **c["kw"]).values)
        got = out[name, "resident"][:, :want.shape[1]]
        diff = np.abs(got - want)
        scale = float(np.abs(want).max())
        above = int((diff > REL_TOL * scale).sum())
        log(f"    {name}: max {diff.max():.3e}, p999 {np.quantile(diff, 0.999):.3e}, {above} of "
            f"{diff.size} entries above {REL_TOL} * max (max |CPU| {scale:.4g})")
        bounds = ((np.quantile(diff, 0.999), REL_TOL), (diff.max(), 2e-2)) if c["solar"] \
            else ((diff.max(), REL_TOL),)
        for got_, rel in bounds:
            if not got_ <= rel * scale:
                raise RuntimeError(f"{name}: card vs CPU {got_} above {rel} * {scale}")
    log(f"    (the CPU runs took {time.perf_counter() - t0:.1f} s)")
    return entries, out["runoff_smoothed", "resident"]


def line_plan(cut, L, K, rng):
    """(cell index, mask, psi) of L straight lines on the grid: each from a
    random point, 0.1-0.8 deg long in a random direction, sampled at 64
    points and mapped to the cells it crosses (the first K), psi its
    azimuth folded into [0, pi) as the JAX line_rating folds it."""
    g = cut.grid_desc
    Y, X = cut.shape
    lo, hi = np.array([g.x[0], g.y[0]]), np.array([g.x[-1], g.y[-1]])
    start = rng.uniform(lo, hi, (L, 2))
    ang = rng.uniform(0.0, 2 * np.pi, L)
    end = np.clip(start + rng.uniform(0.1, 0.8, L)[:, None]
                  * np.stack([np.cos(ang), np.sin(ang)], axis=1), lo, hi)
    pts = start[:, None] + np.linspace(0.0, 1.0, 64)[None, :, None] * (end - start)[:, None]
    ix = np.clip(np.rint((pts[..., 0] - g.x[0]) / (g.x[1] - g.x[0])), 0, X - 1).astype(np.int64)
    iy = np.clip(np.rint((pts[..., 1] - g.y[0]) / (g.y[1] - g.y[0])), 0, Y - 1).astype(np.int64)
    cells = iy * X + ix
    idx = np.zeros((L, K), np.int64)
    mask = np.zeros((L, K), bool)
    for i in range(L):
        u = cells[i][np.sort(np.unique(cells[i], return_index=True)[1])][:K]
        idx[i, :len(u)], mask[i, :len(u)] = u, True
    psi = np.arctan2(start[:, 0] - end[:, 0], start[:, 1] - end[:, 1])
    return idx, mask, np.where(psi >= 0, psi, psi + np.pi)


def physics_phase(cut, runoff, card):
    """Phase 12, end: the line-rating and hydro physics on the card
    against their CPU results; returns their JSON entries."""
    entries = []
    L, K, T = LR_SHAPE
    C = cut.shape[0] * cut.shape[1]
    rng = np.random.default_rng(12)
    t0 = time.perf_counter()
    idx, mask, psi = line_plan(cut, L, K, rng)
    fields = cut.fields()
    flat_idx = torch.as_tensor(idx, device="cuda")
    gathered = {}
    for v in ("temperature", "wnd100m", "wnd_azimuth", "influx_direct", "solar_altitude",
              "solar_azimuth"):
        gathered[v] = fields[v][:T].reshape(T, C)[:, flat_idx].permute(1, 2, 0).contiguous()
    gathered["height"] = fields["height"].reshape(C)[flat_idx][..., None].contiguous()
    dmask = torch.as_tensor(mask, device="cuda")
    params = (psi, np.full(L, 1e-4), np.full(L, 0.028), np.full(L, 373.0), np.full(L, 0.6),
              np.full(L, 0.6))
    torch.cuda.synchronize()
    log(f"line rating on {card}: L={L} lines (mean {mask.sum(1).mean():.1f} of K={K} cells), "
        f"T={T} h; set-up (plan from straight segments in numpy, gather on the card) "
        f"{time.perf_counter() - t0:.2f} s")
    card_ms = cuda_ms(lambda: line_rating_physics.batched_line_rating(gathered, dmask, *params),
                      reps=5, warmup=1)
    got = line_rating_physics.batched_line_rating(gathered, dmask, *params).cpu()
    cpu_in = {k: v.cpu() for k, v in gathered.items()}
    t0 = time.perf_counter()
    want = line_rating_physics.batched_line_rating(cpu_in, torch.as_tensor(mask), *params)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    err = compare("batched_line_rating, card vs CPU", got, want)
    n_bytes = 4 * (6 * L * K * T + L * K + L * T) + L * K
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    log(f"  card {card_ms:.3f} ms (CUDA events, 5 calls), CPU {cpu_ms:.1f} ms; byte bound "
        f"{bound_ms:.3f} ms ({n_bytes / 1e9:.3f} GB at 3.35 TB/s); {int(torch.isnan(got).sum())} "
        f"NaN entries")
    entries.append({"name": "batched_line_rating", "shape": [L, K, T], "ms": card_ms,
                    "cpu_ms": cpu_ms, "bound_ms": bound_ms, "max_abs_err": err})
    del gathered, cpu_in

    n_plants, per_plant, max_shift = HYDRO_SHAPE
    B, T = runoff.shape
    P = n_plants * per_plant
    pair_plant = np.repeat(np.arange(n_plants), per_plant)
    pair_basin = rng.integers(0, B, P)
    pair_shift = rng.integers(0, max_shift + 1, P)
    r_cpu = torch.as_tensor(runoff, dtype=torch.float32)
    r_card = r_cpu.cuda()
    pairs = [torch.as_tensor(a, device="cuda") for a in (pair_plant, pair_basin, pair_shift)]
    card_ms = cuda_ms(lambda: hydro_physics.shift_and_aggregate(r_card, *pairs, n_plants),
                      reps=20)
    got = hydro_physics.shift_and_aggregate(r_card, *pairs, n_plants).cpu()
    t0 = time.perf_counter()
    want = hydro_physics.shift_and_aggregate(r_cpu, pair_plant, pair_basin, pair_shift, n_plants)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    err = compare("shift_and_aggregate, card vs CPU", got, want)
    n_bytes = 4 * (B * T + n_plants * T) + 3 * 8 * P
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    log(f"  shift_and_aggregate: {n_plants} plants, {P} (plant, basin) pairs of {B} basins, "
        f"shifts 0-{max_shift} h, T={T}: card {card_ms:.4f} ms (CUDA events, 20 calls), CPU "
        f"{cpu_ms:.1f} ms; byte bound {bound_ms:.4f} ms ({n_bytes / 1e6:.2f} MB: the runoff, "
        f"the pairs and the output once)")
    entries.append({"name": "shift_and_aggregate", "shape": [n_plants, P, B, T], "ms": card_ms,
                    "cpu_ms": cpu_ms, "bound_ms": bound_ms, "max_abs_err": err})
    return entries


# phase 13: bench_continental.py's extent (its regions span the cell
# centres), the region count of the numpy timing, the lines and plants
CONT_EXTENT = (-12.0, 18.0, 35.0, 60.0)  # x0, x1, y0, y1
NUMPY_REGIONS = 256
N_LINES, N_PLANTS = 2048, 500
BASIN_BLOCK = 8  # basins drain within 8 x 8 blocks of regions, to the block's south-west


def continental_regions(ny, nx):
    """{label: box} of ny x nx rectangles over the extent, as
    bench_continental.py builds them."""
    x0, x1, y0, y1 = CONT_EXTENT
    gx, gy = np.linspace(x0, x1, nx + 1), np.linspace(y0, y1, ny + 1)
    return {f"r{iy}_{ix}": box(gx[ix], gy[iy], gx[ix + 1], gy[iy + 1])
            for iy in range(ny) for ix in range(nx)}


def same_matrix(name, got, want, atol):
    """(max diff, entries in one pattern only) of two sparse matrices;
    raises unless every entry, of either pattern, agrees within ``atol``
    (an entry only one of them stores must itself be below it)."""
    got, want = sp.csr_matrix(got), sp.csr_matrix(want)
    if got.shape != want.shape:
        raise RuntimeError(f"{name}: shapes {got.shape} and {want.shape}")
    diff = abs(got - want)
    err = float(diff.max()) if diff.nnz else 0.0
    apart = int(abs((got != 0).astype(np.int8) - (want != 0).astype(np.int8)).sum())
    if not err <= atol:
        raise RuntimeError(f"{name}: entries differ by {err}, above {atol}")
    return err, apart


def timed_call(fn):
    """(result, wall s, (busy ms, idle share) or None) of one call under
    torch.profiler, the card synchronised before and after."""
    torch.cuda.synchronize()
    with profiled() as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return res, wall, device_idle(prof, wall * 1e3)


def trace_note(idle):
    return ("the trace holds no device record: busy and idle not measured" if idle is None
            else f"device busy {idle[0]:.1f} ms, idle share {idle[1]:.3f}")


def check_close(name, got, want, bounds):
    """Raise unless |got - want| stays within each (statistic, rel) of
    ``bounds`` times max|want|; NaN masks must agree."""
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    if got.shape != want.shape or not np.array_equal(np.isnan(got), np.isnan(want)):
        raise RuntimeError(f"{name}: shapes {got.shape}/{want.shape} or NaN masks differ")
    ok = ~np.isnan(want)
    diff = np.abs(got[ok] - want[ok])
    scale = float(np.abs(want[ok]).max())
    stats = {"max": float(diff.max()), "p999": float(np.quantile(diff, 0.999))}
    log(f"    {name}: max {stats['max']:.3e}, p999 {stats['p999']:.3e} (max |CPU| {scale:.4g})")
    for stat, rel in bounds:
        if not stats[stat] <= rel * scale:
            raise RuntimeError(f"{name}: {stat} {stats[stat]} above {rel} * {scale}")
    return stats["max"]


def sub_cutout(cut, names, t1=None, device="cpu"):
    """The cut's named variables (first ``t1`` hours) as a Cutout on
    ``device``, sharing the host arrays."""
    src = cut if t1 is None else cut.isel_time(0, t1)
    return Cutout(data={n: src.data[n] for n in names}, grid_desc=src.grid_desc,
                  attrs=src.attrs, var_attrs={n: src.var_attrs[n] for n in names},
                  device=device)


def line_shapes(cut, n, rng):
    """n polylines of five points: from a random point, 0.1-0.8 deg in a
    random direction, the three inner points moved sideways a little."""
    g = cut.grid_desc
    lo, hi = np.array([g.x[0], g.y[0]]), np.array([g.x[-1], g.y[-1]])
    start = rng.uniform(lo, hi, (n, 2))
    ang = rng.uniform(0.0, 2 * np.pi, n)
    step = rng.uniform(0.1, 0.8, n)[:, None] * np.stack([np.cos(ang), np.sin(ang)], axis=1)
    t = np.linspace(0.0, 1.0, 5)
    wiggle = np.r_[0.0, 1.0, 1.0, 1.0, 0.0][None, :, None] * rng.normal(0.0, 0.02, (n, 5, 2))
    pts = np.clip(start[:, None] + t[None, :, None] * step[:, None] + wiggle, lo, hi)
    return [LineString(p) for p in pts]


def basin_forest(regions, ny, nx, rng):
    """Columns of a HydroBASINS-like table over the region boxes: in each
    BASIN_BLOCK x BASIN_BLOCK block a tree drains west or south to the
    block's south-west basin (NEXT_DOWN 0 there), DIST_MAIN growing by
    20-90 km a step; ids shuffled."""
    boxes = list(regions.values())
    ids = rng.permutation(np.arange(1, ny * nx + 1)) * 10
    down, dist = np.zeros(ny * nx, np.int64), np.zeros(ny * nx)
    for s in range(2 * BASIN_BLOCK - 1):  # by distance from each block's corner
        for iy in range(ny):
            for ix in range(nx):
                jy, jx = iy % BASIN_BLOCK, ix % BASIN_BLOCK
                if jy + jx != s or s == 0:
                    continue
                nb = [(iy - 1, ix)] * (jy > 0) + [(iy, ix - 1)] * (jx > 0)
                ty, tx = nb[rng.integers(len(nb))]
                down[iy * nx + ix] = ids[ty * nx + tx]
                dist[iy * nx + ix] = dist[ty * nx + tx] + rng.uniform(20.0, 90.0)
    return {"HYBAS_ID": ids.tolist(), "NEXT_DOWN": down.tolist(), "DIST_MAIN": dist.tolist(),
            "geometry": boxes}


def gis_phase(cut, card, regions_shape=CONT_REGIONS, n_lines=N_LINES, n_plants=N_PLANTS,
              n_numpy=NUMPY_REGIONS):
    """Phase 13: geometry to (bus, time) series on the continental cut;
    returns its entries of the converters line."""
    T, (Y, X) = len(cut.grid_desc.time), cut.shape
    C = Y * X
    entries = []
    log(f"geometry on {card} (T={T} h, C={C}):")
    t0 = time.perf_counter()
    lib = native.get_lib()
    if lib is None:
        raise RuntimeError("the C++ geometry engine did not build or load")
    log(f"  C++ geometry engine: {native.library_path().name}, built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")

    # ---- the indicator matrix, by the engine and by numpy
    ny, nx = regions_shape
    regions = continental_regions(ny, nx)
    t0 = time.perf_counter()
    matrix = sp.csr_matrix(cut.indicatormatrix(regions))
    engine_s = time.perf_counter() - t0
    first = dict(list(regions.items())[:n_numpy])
    saved = native.get_lib
    native.get_lib = lambda: None  # the numpy clipper, for the same regions
    try:
        t0 = time.perf_counter()
        plain = cut.indicatormatrix(first)
        numpy_s = time.perf_counter() - t0
    finally:
        native.get_lib = saved
    # the two clip and sum in another order: 1e-12 of area (squared degrees),
    # as tests/test_native.py holds them, in units of the cell's area
    g = cut.grid_desc
    atol = 1e-12 / (g.dx * g.dy)
    err, apart = same_matrix("indicator matrix, engine vs numpy", matrix[:n_numpy], plain, atol)
    t0 = time.perf_counter()
    engine_first = cut.indicatormatrix(first)
    engine_first_s = time.perf_counter() - t0
    same_matrix("indicator matrix, engine on its own rows", matrix[:n_numpy], engine_first, 0.0)
    B = matrix.shape[0]
    nb, W, route = aggregation_route(matrix)
    log(f"  indicator matrix of {B} regions: {engine_s:.3f} s by the engine; the first "
        f"{n_numpy}: {engine_first_s:.3f} s by the engine, {numpy_s:.2f} s by numpy (the same "
        f"matrix: entries within {err:.1e} of {atol:.1e}, {apart} stored by one side only, "
        f"slivers of cells that a region's edge meets); {matrix.nnz} entries (phase 9's matrix, "
        f"each cell to one region by its centre: {C}), rows summing to {matrix.sum(axis=1).min():.3f}-"
        f"{matrix.sum(axis=1).max():.3f} cells; banded nb={nb} W={W}; route {route}")
    if route != "banded":
        raise RuntimeError(f"the indicator matrix takes the {route} route, not banded")
    entries.append({"name": "indicatormatrix", "regions": B, "engine_s": engine_s,
                    "numpy_regions": n_numpy, "numpy_s": numpy_s, "numpy_max_diff": err,
                    "numpy_entries_apart": apart,
                    "engine_s_same_regions": engine_first_s, "nnz": int(matrix.nnz),
                    "nb": nb, "W": W})

    # ---- wind by shapes, PV by layout and shapes
    layout = cut.uniform_density_layout(1e-6, crs=3035)  # 1 MW a km^2
    pv_orient = {"slope": 30.0, "azimuth": 180.0}
    runs = {
        "wind_shapes": (
            lambda c, **k: c.wind("Vestas_V112_3MW", per_unit=True, aggregate_time=None, **k),
            "wind"),
        "pv_layout_shapes": (
            lambda c, **k: c.pv("CSi", pv_orient, layout=layout, aggregate_time=None, **k),
            "pv"),
    }
    cpu = sub_cutout(cut, list(cut.data), t1=48)
    for name, (fn, kind) in runs.items():
        wind_pv_bus_megakernel.launches = bsr_spmm_kernel.launches = 0
        res, wall, idle = timed_call(lambda: fn(cut, shapes=regions))
        vals = np.asarray(res.values)
        if vals.shape != (B, T) or not np.isfinite(vals).all():
            raise RuntimeError(f"{name}: {vals.shape}, finite {np.isfinite(vals).all()}")
        by_matrix = np.asarray(fn(cut, matrix=matrix).values)
        if not np.array_equal(vals, by_matrix):
            raise RuntimeError(f"{name}: shapes= and matrix= give other bits")
        log(f"  {name}: {wall:.3f} s resident, the indicator matrix included (host work "
            f"included, under torch.profiler); {trace_note(idle)}; kernel launches "
            f"{wind_pv_bus_megakernel.launches + bsr_spmm_kernel.launches}; equal bit for bit "
            "to the call with the matrix; first 48 h against the CPU:")
        want = np.asarray(fn(cpu, matrix=matrix).values)
        bounds = (("max", REL_TOL),) if kind == "wind" else (("p999", REL_TOL), ("max", 2e-2))
        err = check_close(name, vals[:, :48], want, bounds)
        entries.append({"name": name, "wall_s": wall, "busy_ms": idle and idle[0],
                        "idle_share": idle and idle[1], "max_abs_err_cpu": err})

    # ---- line rating
    rng = np.random.default_rng(13)
    lines = line_shapes(cut, n_lines, rng)
    t0 = time.perf_counter()
    inter = sp.csr_matrix(cut.intersectionmatrix(lines))
    inter_s = time.perf_counter() - t0
    K = int(np.diff(inter.indptr).max())
    res, wall, idle = timed_call(lambda: cut.line_rating(lines, line_resistance=1e-4))
    vals = np.asarray(res.values)
    if vals.shape != (n_lines, T) or not np.isfinite(vals).any():
        raise RuntimeError(f"line_rating: {vals.shape}")
    chunk = max(1, min(T, int(48e6 // max(1, n_lines * K))))
    log(f"  line_rating: {n_lines} lines of four segments, {inter.nnz} cells (K={K} a line at "
        f"most, mean {inter.nnz / n_lines:.1f}); intersection matrix {inter_s:.3f} s on the host; "
        f"the call {wall:.3f} s (the intersection matrix, the plan, {-(-T // chunk)} chunk(s) of "
        f"{chunk} h gathered on the card and rated; host work included, under torch.profiler); "
        f"{trace_note(idle)}; {int(np.isnan(vals).sum())} NaN entries (phase 12 times "
        "batched_line_rating alone at 2048 x 16 x 720 h); first 48 h against the CPU:")
    lr_cpu = sub_cutout(cut, [v for v in conv._LINE_FIELDS], t1=48)
    err = check_close("line_rating", vals[:, :48],
                      lr_cpu.line_rating(lines, line_resistance=1e-4).values,
                      (("max", REL_TOL),))
    entries.append({"name": "line_rating", "lines": n_lines, "K": K, "intersection_s": inter_s,
                    "wall_s": wall, "busy_ms": idle and idle[0], "idle_share": idle and idle[1],
                    "max_abs_err_cpu": err})

    # ---- hydro
    basins = basin_forest(regions, ny, nx, rng)
    x0, x1, y0, y1 = CONT_EXTENT
    plants = {"lon": rng.uniform(x0 + 0.01, x1 - 0.01, n_plants).tolist(),
              "lat": rng.uniform(y0 + 0.01, y1 - 0.01, n_plants).tolist()}
    res, wall, idle = timed_call(lambda: cut.hydro(plants, basins, aggregate_time=None))
    vals = np.asarray(res.values)
    if vals.shape != (n_plants, T) or not np.isfinite(vals).all() or not vals.max() > 0:
        raise RuntimeError(f"hydro: {vals.shape}, finite {np.isfinite(vals).all()}")
    t0 = time.perf_counter()
    want = sub_cutout(cut, ["runoff", "height"]).hydro(plants, basins, aggregate_time=None).values
    cpu_s = time.perf_counter() - t0
    log(f"  hydro: {n_plants} plants, {len(basins['HYBAS_ID'])} basins in {len(basins['HYBAS_ID']) // BASIN_BLOCK ** 2} "
        f"trees; {wall:.3f} s (basins, their indicator matrix, runoff, routing; host work "
        f"included, under torch.profiler); {trace_note(idle)}; the CPU {cpu_s:.2f} s; against "
        "the CPU over all hours:")
    err = check_close("hydro", vals, want, (("max", REL_TOL),))
    entries.append({"name": "hydro", "plants": n_plants, "basins": len(basins["HYBAS_ID"]),
                    "wall_s": wall, "busy_ms": idle and idle[0], "idle_share": idle and idle[1],
                    "cpu_s": cpu_s, "max_abs_err_cpu": err})

    # ---- another turbine, smoothed
    res, wall, idle = timed_call(lambda: cut.wind("NREL_ReferenceTurbine_2020ATB_5.5MW",
                                                  smooth=True, matrix=matrix,
                                                  aggregate_time=None))
    vals = np.asarray(res.values)
    if vals.shape != (B, T) or not np.isfinite(vals).all():
        raise RuntimeError(f"smoothed wind: {vals.shape}, finite {np.isfinite(vals).all()}")
    log(f"  wind, NREL_ReferenceTurbine_2020ATB_5.5MW smoothed: {wall:.3f} s resident; "
        f"{trace_note(idle)}; finite ({B}, {T}), mean {vals.mean():.4g} MW a region")
    entries.append({"name": "wind_smoothed", "wall_s": wall, "busy_ms": idle and idle[0],
                    "idle_share": idle and idle[1]})
    return entries


# phase 14: the continental cut through an .atc store, written inside the
# checkout (build/ is ignored by git) and removed at the end
STORE_DIR = Path(__file__).resolve().parent / "build" / "store_phase"
SUB_BOX = 64  # cells a side of the sel/merge check


def cached_share(files):
    """Share of the files' pages in the page cache (mincore on a fresh
    read-only mapping of each)."""
    libc = ctypes.CDLL(None, use_errno=True)
    libc.mmap.restype = ctypes.c_void_p
    libc.mmap.argtypes = (ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_long)
    libc.munmap.argtypes = (ctypes.c_void_p, ctypes.c_size_t)
    libc.mincore.argtypes = (ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_ubyte))
    page = os.sysconf("SC_PAGE_SIZE")
    pages = cached = 0
    for fn in files:
        size = os.path.getsize(fn)
        n = (size + page - 1) // page
        with open(fn, "rb") as f:
            addr = libc.mmap(None, size, mmap.PROT_READ, mmap.MAP_SHARED, f.fileno(), 0)
            if addr in (None, ctypes.c_void_p(-1).value):
                raise OSError(ctypes.get_errno(), f"mmap of {fn} failed")
            vec = (ctypes.c_ubyte * n)()
            try:
                if libc.mincore(addr, size, vec) != 0:
                    raise OSError(ctypes.get_errno(), f"mincore of {fn} failed")
            finally:
                libc.munmap(addr, size)
        pages += n
        cached += sum(b & 1 for b in vec)
    return cached / pages


def fs_type(path):
    """The type of the file system that holds ``path`` (/proc/self/mounts)."""
    best, kind = "", "unknown"
    with open("/proc/self/mounts", encoding="utf-8") as f:
        for line in f:
            _, mount, fstype = line.split()[:3]
            if str(path).startswith(mount) and len(mount) > len(best):
                best, kind = mount, fstype
    return kind


def drop_from_cache(files):
    """Flush each file and drop its pages from the page cache
    (POSIX_FADV_DONTNEED; pages still mapped by a process stay)."""
    for fn in files:
        fd = os.open(fn, os.O_RDONLY)
        try:
            os.fsync(fd)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)


def store_phase(cut, matrix, card, in_memory):
    """Phase 14: write the continental cut to an .atc store, reopen it
    (memory maps) and run phase 10's calls from it; every result must
    equal the in-memory cut's bit for bit.  Returns its entries of the
    converters line."""
    T, (Y, X) = len(cut.grid_desc.time), cut.shape
    C, B = Y * X, matrix.shape[0]
    nb, W = banded_width(matrix)
    band_flops = 2 * nb * 128 * W * CHUNK
    windows = [(t, t + CHUNK) for t in range(0, T, CHUNK)]
    STORE_DIR.mkdir(parents=True, exist_ok=True)
    nbytes = sum(np.asarray(a).nbytes for a in cut.data.values())
    free = shutil.disk_usage(STORE_DIR).free
    log(f"store phase on {card}: {len(cut.data)} variables, {nbytes / 1e9:.3f} GB of arrays; "
        f"{free / 1e9:.1f} GB free in {STORE_DIR} ({fs_type(STORE_DIR)})")
    if free < 2 * nbytes:
        raise RuntimeError(f"{free / 1e9:.1f} GB free, the store needs twice its "
                           f"{nbytes / 1e9:.3f} GB")
    tmp = Path(tempfile.mkdtemp(dir=STORE_DIR))
    path = tmp / "europe.atc"
    entries = []
    real_digest = store._file_digest
    try:
        # 1. write, the sha256 of each file timed apart
        hash_s = []

        def timed_digest(fn):
            t0 = time.perf_counter()
            digest = real_digest(fn)
            hash_s.append(time.perf_counter() - t0)
            return digest

        store._file_digest = timed_digest
        t0 = time.perf_counter()
        cut.to_file(path)
        write_s = time.perf_counter() - t0
        store._file_digest = real_digest
        hash_s = sum(hash_s)
        files = sorted(path.glob("*.npy"))
        size = sum(f.stat().st_size for f in files)
        log(f"  to_file: {write_s:.2f} s for {size / 1e9:.3f} GB in {len(files)} files = "
            f"{size / write_s / 1e9:.2f} GB/s (into the page cache: nothing is flushed), of "
            f"which sha256 {hash_s:.2f} s ({hash_s / write_s:.1%}, "
            f"{size / hash_s / 1e9:.2f} GB/s)")
        # 2. reopen
        t0 = time.perf_counter()
        reopened = Cutout(path)
        open_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        store.read_store(path, verify=True)
        verify_s = time.perf_counter() - t0
        if not all(isinstance(a, np.memmap) for a in reopened.data.values()):
            raise RuntimeError("the reopened cutout does not hold memory maps")
        log(f"  Cutout(path): {open_s * 1e3:.1f} ms (memory maps); read_store(verify=True): "
            f"{verify_s:.2f} s = {size / verify_s / 1e9:.2f} GB/s (sha256 of every file, warm)")
        entries.append({"name": "store", "GB": size / 1e9, "write_s": write_s,
                        "hash_s": hash_s, "reopen_s": open_s, "verify_s": verify_s,
                        "free_GB": free / 1e9, "fs": fs_type(STORE_DIR)})
        del reopened

        def from_store(modes, suffix="", ring=None):
            """Phase 10's calls in ``modes`` from a fresh reopen of the store,
            by (name, mode + suffix); set-up first on a cutout without
            pinned buffers (``ring``): a streamed raw PV call sizes them, and
            the resident fields are staged from the memory maps.  Returns the
            results and the Cutout's pinned ring; nothing else stays mapped."""
            c = Cutout(path)
            c._ring = ring
            runs = continental_runs(c, matrix)
            if ring is None:
                runs["pv"](**CONT_MODES["streamed raw"])
                t0 = time.perf_counter()
                stage_all(c)
                torch.cuda.synchronize()
                log(f"  set-up: pinned buffers; resident staging from the memory maps "
                    f"{time.perf_counter() - t0:.2f} s")
            return {(name, mode + suffix): timed_mode(name, f"{mode}{suffix} (store)", fn,
                                                      CONT_MODES[mode], (B, T, C), windows,
                                                      band_flops)
                    for mode in modes for name, fn in runs.items()}, c._ring

        # 3. the runs from the reopened store, warm; then cold: the maps
        # gone, the files flushed and dropped from the page cache
        results, ring = from_store(list(CONT_MODES))
        gc.collect()
        warm_share = cached_share(files)
        t0 = time.perf_counter()
        drop_from_cache(files)
        cold_share = cached_share(files)
        log(f"  page cache: {warm_share:.1%} of the store's pages before, "
            f"{cold_share:.1%} after fsync + POSIX_FADV_DONTNEED "
            f"({time.perf_counter() - t0:.2f} s)"
            + (": the file system keeps them, so the cold runs read a warm cache"
               if cold_share > 0.5 else ""))
        entries[0].update(cached_before=warm_share, cached_after_drop=cold_share)
        results.update(from_store(["streamed raw"], " cold", ring)[0])
        log(f"  page cache after the cold runs: {cached_share(files):.1%}")
        # 4. checks: the same float32 bytes through the same code
        for (name, mode), r in results.items():
            want = in_memory[name, mode.replace(" cold", "")]
            if not np.array_equal(r["vals"], want):
                diff = np.abs(r["vals"] - want)
                raise RuntimeError(f"{name} {mode} from the store differs from the in-memory "
                                   f"cut: max {diff.max()}")
            chunks = r["chunks"].values()
            entries.append({"name": f"store {name}", "mode": mode, "wall_s": r["wall"],
                            "cell_hours_per_s": T * C / r["wall"],
                            "busy_ms": r["idle"] and r["idle"][0],
                            "idle": r["idle"] and r["idle"][1],
                            "pack_ms": [c["pack"] - c.get("pin", 0.0) for c in chunks],
                            "copy_ms": [c.get("copy", 0.0) for c in chunks]})
        rate = profiling.Throughput()
        for r in results.values():
            rate.add(T * C, r["wall"])
        log(f"  checks: {len(results)} results from the store equal the in-memory cut's bit "
            f"for bit; together {rate.cell_hours / 1e9:.2f}G cell-hours in {rate.seconds:.2f} s "
            f"= {rate.rate:.4g} cell-hours/s")
        # 5. sel of a sub-box, merge of two feature sets
        sub_x, sub_y = cut.grid_desc.x[:SUB_BOX], cut.grid_desc.y[-SUB_BOX:]
        box_cut = Cutout(path).sel(x=slice(sub_x[0], sub_x[-1]), y=slice(sub_y[0], sub_y[-1]))
        g = cut.grid_desc
        expected = Cutout(
            data={n: (np.asarray(a)[:, -SUB_BOX:, :SUB_BOX] if np.ndim(a) == 3 else
                      np.asarray(a)[-SUB_BOX:, :SUB_BOX]) for n, a in cut.data.items()},
            grid_desc=dataclasses.replace(g, x=sub_x, y=sub_y), attrs=cut.attrs,
            var_attrs=cut.var_attrs)
        wind_vars = [n for n in box_cut.data if box_cut.var_attrs[n].get("feature") == "wind"]
        parts = [sub_cutout(box_cut, names, device=box_cut.device)
                 for names in (wind_vars, [n for n in box_cut.data if n not in wind_vars])]
        merged = parts[0].merge(parts[1])
        if box_cut.shape != (SUB_BOX, SUB_BOX) or not box_cut.equals(expected) \
                or not merged.equals(expected):
            raise RuntimeError(f"sel/merge: shape {box_cut.shape}, sel equals "
                               f"{box_cut.equals(expected)}, merge equals "
                               f"{merged.equals(expected)}")
        log(f"  sel of a {SUB_BOX} x {SUB_BOX} box and merge of its wind and other variables "
            "equal the cut's arrays")
    finally:
        store._file_digest = real_digest
        shutil.rmtree(tmp, ignore_errors=True)
    return entries


# phase 15: availability (land eligibility) on the card, bench.py's two
# workloads and bench_continental.py's stage 5, each against the host path
AVAIL_BOUNDS = (-4, 56, 1.5, 62)
AVAIL_TOL = 2e-2            # device against host, as bench.py:106-112
AVAIL_RES_M = 100.0         # bench_continental.py's continental lattice
N_AVAIL_SHAPES = 40
AVAIL_HOST_SHAPES = 4
REGRID_HOURS = 168          # a week of the continental wind field
MASK_RANGE = re.compile(r"mask (\d+):(\d+)$")  # the cold build's ranges (gis/kernels.py)


# the wrappers around the name of what a PyTorch kernel computes
KERNEL_WRAPPERS = re.compile(r"^void |at::native::|\(anonymous namespace\)::|at::cuda::|"
                             r"(vectorized_|unrolled_)?elementwise_kernel<\d+, (\d+, )?|"
                             r"gpu_kernel_impl(_nocast)?<")


def kernel_name(name):
    """A profiler kernel name without PyTorch's wrappers, 60 characters."""
    return KERNEL_WRAPPERS.sub("", name)[:60]


def landuse_3035(lon, lat, res, seed=0):
    """bench.py's and bench_continental.py's land-use raster: codes 1-5 at
    ``res`` m in EPSG:3035 over the points' cover plus 5 km, its origin
    off the res lattice by 37 m (so the mask build samples it by the
    separable nearest path, not by slices)."""
    ex, ey = transform_points(np.asarray(lon, float), np.asarray(lat, float), 4326, 3035)
    rx, ry = int((ex.max() - ex.min() + 1e4) / res) + 2, int((ey.max() - ey.min() + 1e4) / res) + 2
    data = np.random.default_rng(seed).integers(1, 6, (ry, rx), dtype=np.uint8)
    return Raster(data, Affine(res, 0, ex.min() - 5e3 - 37.0, 0, -res, ey.max() + 5e3 + 37.0),
                  3035, 255)


def excluder_of(raster, crs, res):
    def make():
        exc = ExclusionContainer(crs, res=res)
        exc.add_raster(raster, codes=[4, 5])
        return exc
    return make


def availability_case(name, cutout, shapes, make_exc, card):
    """One availability workload on the card through
    ``cutout.availabilitymatrix``: cold (a fresh excluder: the host layers'
    mask built on the worker thread, packed upload) and warm (that mask
    cached on the card; an aligned raster is sampled again) wall s,
    window Mpix/s, busy ms and idle share of a warm and of a cold call
    (torch.profiler), the host's mask build ms a block (its ranges in the
    cold trace), peak device memory and the host layers' mask's bytes;
    the first shapes against the host path within AVAIL_TOL.  Returns its
    entry of the availability line."""
    S, (NY, NX) = len(shapes), cutout.shape
    counted = avail_kernels.availability_matrix_device
    exc = make_exc()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # earlier phases' tensors
    pix0 = counted.window_pixels
    t0 = time.perf_counter()
    out = cutout.availabilitymatrix(shapes, exc)
    cold_s = time.perf_counter() - t0
    peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    P = counted.window_pixels - pix0  # the fine pixels of the shapes' windows
    dev = out.values
    if dev.shape != (S, NY, NX) or not np.isfinite(dev).all() or dev.min() < 0 \
            or dev.max() > 1 + 1e-6:
        raise RuntimeError(f"{name}: availability {dev.shape}, finite "
                           f"{np.isfinite(dev).all()}, range {dev.min()}..{dev.max()}")
    # the shape-independent host mask, where the excluder has host layers
    mask = getattr(exc, "_fine_mask_cache", (None, None))[1]
    if mask is not None and mask.device.type != "cuda":
        raise RuntimeError(f"{name}: the fine mask is not on the card")
    mask_mb = 0.0 if mask is None else mask.numel() * mask.element_size() / 1e6
    warm = []
    for _ in range(2):
        t0 = time.perf_counter()
        again = cutout.availabilitymatrix(shapes, exc).values
        warm.append(time.perf_counter() - t0)
        if not np.array_equal(again, dev):
            raise RuntimeError(f"{name}: a warm call gave other values than the cold one")
    warm_s = min(warm)
    torch.cuda.synchronize()
    with profiled() as prof:
        t0 = time.perf_counter()
        cutout.availabilitymatrix(shapes, exc)
        torch.cuda.synchronize()
        warm_wall = time.perf_counter() - t0
    warm_idle = device_idle(prof, warm_wall * 1e3)
    by_kernel = sorted(((kernel_name(e.key), e.device_time_total / 1e3)
                        for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA and e.device_time_total > 0),
                       key=lambda kv: -kv[1])
    torch.cuda.synchronize()
    fresh = make_exc()
    with profiled() as prof:
        t0 = time.perf_counter()
        cutout.availabilitymatrix(shapes, fresh)
        torch.cuda.synchronize()
        cold_wall = time.perf_counter() - t0
    cold_idle = device_idle(prof, cold_wall * 1e3)
    build_ms = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                if MASK_RANGE.match(e.name)]
    del fresh, prof
    exc_h = make_exc()
    t0 = time.perf_counter()
    host = cutout.availabilitymatrix(shapes[:AVAIL_HOST_SHAPES], exc_h, backend="host").values
    host_s = time.perf_counter() - t0
    diff = float(np.abs(dev[:AVAIL_HOST_SHAPES] - host).max())
    if not diff < AVAIL_TOL:
        raise RuntimeError(f"{name}: the card's availability is {diff} from the host path's")
    E = avail_kernels.shapes_to_edges(shapes)[0].shape[1]
    n_ops, n_bytes = E * P, P + 4 * S * NY * NX
    ops_ms, bytes_ms = n_ops / FP32_FLOPS * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    log(f"  {name}: {S} shapes of {E} edges, their windows {P / 1e6:.1f} Mpix, onto {NY} x "
        f"{NX} cells; shared host mask {mask_mb:.1f} MB on the card; "
        f"peak device memory of the cold call {peak_gb:.2f} GB above what earlier phases hold")
    log(f"    cold {cold_s:.3f} s, warm {warm_s:.3f} s (runs {', '.join(f'{w:.3f}' for w in warm)}) "
        f"= {P / warm_s / 1e6:.1f} Mpix-shapes/s; warm under the profiler {warm_wall:.3f} s, "
        f"{trace_note(warm_idle)}; cold under the profiler {cold_wall:.3f} s, "
        f"{trace_note(cold_idle)}")
    if by_kernel:
        log("    warm device time by kernel (torch.profiler): " + "; ".join(
            f"{ms:.2f} ms {name}" for name, ms in by_kernel[:8]))
    if build_ms:
        log(f"    host mask build, {len(build_ms)} blocks: mean {np.mean(build_ms):.2f} ms, max "
            f"{max(build_ms):.2f} ms, sum {sum(build_ms) / 1e3:.3f} s (worker thread)")
    else:
        log("    host mask build a block: not in the trace")
    busy = None if warm_idle is None else warm_idle[0]
    log(f"    bound {bound_ms:.4f} ms: {n_ops / 1e9:.2f} G edge tests at 67 TFLOP/s "
        f"{ops_ms:.4f} ms, {n_bytes / 1e6:.1f} MB of mask and partial sums at 3.35 TB/s "
        f"{bytes_ms:.4f} ms; warm busy "
        + ("not measured" if busy is None else f"{busy:.2f} ms = {bound_ms / busy:.1%} of it"))
    log(f"    first {AVAIL_HOST_SHAPES} shapes against the host path ({host_s:.2f} s): max abs "
        f"diff {diff:.3e} (tolerance {AVAIL_TOL}) on {card}")
    return {"name": name, "shapes": S, "edges": E, "fine_mpix": P / 1e6, "cells": NY * NX,
            "blocks": len(build_ms), "cold_s": cold_s, "warm_s": warm_s,
            "mpix_shapes_per_s": P / warm_s / 1e6,
            "warm_busy_ms": busy, "warm_idle": None if warm_idle is None else warm_idle[1],
            "cold_busy_ms": None if cold_idle is None else cold_idle[0],
            "cold_idle": None if cold_idle is None else cold_idle[1],
            "mask_build_ms_per_block": float(np.mean(build_ms)) if build_ms else None,
            "peak_device_gb": peak_gb, "fine_mask_mb": mask_mb,
            "warm_kernels_ms": dict(by_kernel[:8]),
            "bound_ms": bound_ms, "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "host_s": host_s, "max_abs_diff_vs_host": diff, "card": card}


def regrid_check(cut, card, hours=REGRID_HOURS):
    """``regrid`` of the continental wind field (first ``hours`` h, held on
    the card) onto 0.5 and 0.125 deg, average and bilinear, against the
    same call on the field of a CPU cutout: equal bit for bit, within the
    field's range.  Returns its entries of the availability line."""
    g = cut.grid_desc
    hours = min(hours, len(g.time))
    cpu = sub_cutout(cut, ["wnd100m"], t1=hours)
    coords = {"time": g.time[:hours], "y": g.y, "x": g.x}
    on_card = DataArray(torch.as_tensor(np.asarray(cut.data["wnd100m"][:hours]), device="cuda"),
                        coords=coords, dims=("time", "y", "x"))
    on_cpu = DataArray(torch.as_tensor(np.asarray(cpu.data["wnd100m"])), coords=coords,
                       dims=("time", "y", "x"))
    lo, hi = float(on_cpu.values.min()), float(on_cpu.values.max())
    entries = []
    for step in (0.5, 0.125):
        dx = np.arange(g.x[0] + step / 2, g.x[-1], step)
        dy = np.arange(g.y[0] + step / 2, g.y[-1], step)
        for how in ("average", "bilinear"):
            t0 = time.perf_counter()
            got = regrid(on_card, dx, dy, resampling=how)
            host_s = time.perf_counter() - t0
            want = regrid(on_cpu, dx, dy, resampling=how)
            v = got.values
            if v.shape != (hours, len(dy), len(dx)) or not np.array_equal(v, want.values) \
                    or not np.isfinite(v).all() or v.min() < lo - 1e-9 or v.max() > hi + 1e-9:
                raise RuntimeError(f"regrid {how} onto {step} deg: {v.shape}, equal to the CPU "
                                   f"cutout's {np.array_equal(v, want.values)}")
            log(f"  regrid {how} of {hours} h x {g.shape[0]} x {g.shape[1]} onto {step} deg "
                f"({len(dy)} x {len(dx)}): {host_s:.3f} s on the host, bit for bit the CPU "
                f"cutout's, within the field's range")
            entries.append({"name": f"regrid {how} {step}", "host_s": host_s,
                            "shape": list(v.shape), "card": card})
    return entries


def availability_phase(cut, card, res=AVAIL_RES_M):
    """Phase 15: (a) bench.py's same-CRS workload, (b) its cross-CRS one at
    100 m, (c) bench_continental.py's stage 5 on the continental cut at
    ``res`` m; then ``regrid`` of a continental field.  Returns the
    entries of the availability line."""
    log(f"availability on {card}:")
    small = Cutout(module="synthetic", bounds=AVAIL_BOUNDS, time="2013-01-01")
    shapes = [box(x, y, x + 1.2, y + 1.3) for x in np.linspace(-4, 0.5, 5)[:4]
              for y in np.linspace(56, 61, 4)[:3]]
    landuse = Raster(np.random.default_rng(0).integers(1, 6, (640, 580), dtype=np.uint8),
                     Affine(0.01, 0, -4.2, 0, -0.01, 62.3), 4326, 255)
    entries = [availability_case("(a) same CRS, 0.01 deg", small, shapes,
                                 excluder_of(landuse, 4326, 0.01), card)]
    x0, y0, x1, y1 = AVAIL_BOUNDS
    t0 = time.perf_counter()
    raster = landuse_3035([x0, x0, x1, x1], [y0, y1, y0, y1], 100.0)
    log(f"  (b) land-use raster {raster.shape[0]} x {raster.shape[1]} at 100 m "
        f"({time.perf_counter() - t0:.2f} s, set-up)")
    entries.append(availability_case("(b) EPSG:3035 100 m", small, shapes,
                                     excluder_of(raster, 3035, 100.0), card))
    cx0, cx1, cy0, cy1 = CONT_EXTENT
    t0 = time.perf_counter()
    raster = landuse_3035([cx0, cx0, cx1, cx1, (cx0 + cx1) / 2], [cy0, cy1, cy0, cy1, cy1], res)
    log(f"  (c) continental land-use raster {raster.shape[0]} x {raster.shape[1]} at {res:g} m "
        f"({raster.data.size / 1e6:.0f} Mpix, {time.perf_counter() - t0:.2f} s, set-up)")
    sx, sy = np.linspace(cx0 + 0.5, cx1 - 3.5, 8), np.linspace(cy0 + 0.5, cy1 - 3.5, 5)
    cont_shapes = [box(x, y, x + 3.0, y + 3.0) for y in sy for x in sx][:N_AVAIL_SHAPES]
    entries.append(availability_case(f"(c) continental EPSG:3035 {res:g} m", cut, cont_shapes,
                                     excluder_of(raster, 3035, res), card))
    del raster
    gc.collect()
    entries += regrid_check(cut, card)
    return entries


# ---------------------------------------------------------------------------
# phase 16: multiple devices on the card
# ---------------------------------------------------------------------------
N_SHARDS = 8                 # mesh positions; the visible cards repeated to 8
MESH_SIZES = (1, 2, 4, 8)    # bench_multichip.py --sizes 1,2,4,8
MESH_X = 480                 # the continental cut's 481 columns divide no x; 480 do
MESH_HOURS = 720             # the sharded cutout's hours (the first chunk)
GRID_TOL = 1e-6              # sharded against serial regrid, relative to max
MESH_STORE = Path(__file__).resolve().parent / "build" / "phase16_store"


def mesh_devices(n):
    """n mesh positions over the visible cards, in turn."""
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [cards[i % len(cards)] for i in range(n)]


def within_max(name, got, want, tol):
    """Raise unless the NaN masks agree and |got - want| <= tol * max|want|;
    returns the max abs diff."""
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    if got.shape != want.shape or not np.array_equal(np.isnan(got), np.isnan(want)):
        raise RuntimeError(f"{name}: shapes {got.shape}/{want.shape} or NaN masks differ")
    ok = ~np.isnan(want)
    err, scale = float(np.abs(got[ok] - want[ok]).max()), float(np.abs(want[ok]).max())
    log(f"    {name}: max abs diff {err:.3e} (max {scale:.4g}, tolerance {tol * scale:.3e})")
    if not err <= tol * scale:
        raise RuntimeError(f"{name}: max abs diff {err} above {tol} * {scale}")
    return err


def sharded_step_phase(args, nan_args, card):
    """16 (a): the headline step over meshes of MESH_SIZES positions at the
    bench shape, against the unsharded step on the same tensors (and with
    NaN cells); the fused kernel must launch once a shard; CUDA-event ms
    of each beside the unsharded step's, in one call, with the host's
    enqueue time a step."""
    fields, eph, lon, lat, V, POWn, matrix = args
    T, Y, X = fields["wnd100m"].shape
    step = step_fn()
    ref = step(*args)
    ref_nan = step(*nan_args)
    unsharded_ms = [cuda_ms(lambda: step(*args), reps=20)]
    rows, err = [], 0.0
    for n in MESH_SIZES:
        mesh = make_mesh(mesh_devices(n))
        fs, fs_nan = shard_fields(mesh, fields), shard_fields(mesh, nan_args[0])
        sstep = sharded_step_fn(mesh)
        torch.cuda.synchronize()
        wind_pv_bus_megakernel.launches = 0
        w, p = sstep(fs, eph, lon, lat, V, POWn, matrix)
        torch.cuda.synchronize()
        launches = wind_pv_bus_megakernel.launches
        if launches != mesh.size:
            raise RuntimeError(f"mesh {mesh.shape}: {launches} launches of the fused kernel "
                               f"for {mesh.size} shards")
        log(f"  mesh t={mesh.shape['t']} x={mesh.shape['x']} ({n} shards, blocks of "
            f"{T // mesh.shape['t']} h x {Y} x {X // mesh.shape['x']}): {launches} launches")
        err = max(err, compare(f"sharded wind_bus, {n} shards", w.gather(), ref[0]),
                  compare(f"sharded pv_bus, {n} shards", p.gather(), ref[1]))
        wn, pn = sstep(fs_nan, eph, lon, lat, V, POWn, matrix)
        err = max(err, compare(f"sharded wind_bus with NaN cells, {n} shards", wn.gather(),
                               ref_nan[0]),
                  compare(f"sharded pv_bus with NaN cells, {n} shards", pn.gather(), ref_nan[1]))
        call = lambda: sstep(fs, eph, lon, lat, V, POWn, matrix)  # noqa: E731
        ms = cuda_ms(call, reps=20)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            call()
        enqueue = (time.perf_counter() - t0) / 20 * 1e3
        log(f"    {n} shards: {ms:.4f} ms a step (CUDA events), the host enqueues one in "
            f"{enqueue:.4f} ms (perf_counter over 20 calls, no sync)")
        rows.append({"shards": n, "mesh": [mesh.shape["t"], mesh.shape["x"]],
                     "launches": launches, "ms": ms, "enqueue_ms": enqueue})
        del fs, fs_nan, w, p, wn, pn
    unsharded_ms.append(cuda_ms(lambda: step(*args), reps=20))
    base = sum(unsharded_ms) / 2
    log(f"  CUDA events, 20 calls each, on {card}; on one card this is the cost of splitting "
        f"the step, not a scaling result: unsharded {unsharded_ms[0]:.4f}/{unsharded_ms[1]:.4f} "
        f"ms (before/after); " + "; ".join(f"{r['shards']} shards {r['ms']:.4f} ms "
                                           f"({r['ms'] / base:.2f}x)" for r in rows))
    return rows, base, err


def halo_regrid_phase(cut480, card):
    """16 (b): halo values on an 8-way x mesh; ``sharded_regrid_bilinear``
    of the first 168 h of the 480-column wind field onto 0.125 deg on a
    (t=2, x=4) mesh against the serial ``regrid`` of the same hours."""
    mesh = make_mesh(mesh_devices(N_SHARDS), t_axis=1)
    X = 64
    arr = torch.arange(X, dtype=torch.float32, device="cuda").repeat(2, 1, 1)
    s = put_global(arr, NamedSharding(mesh, P(None, None, "x")))
    ident = map_shards(lambda b: b[..., 2:-2], halo_exchange(s, 2)).gather()
    left = map_shards(lambda b: b[..., :-2], halo_exchange(s, 1)).gather()
    if not (torch.equal(ident, arr) and torch.equal(
            left[0, 0].cpu(), torch.clamp(torch.arange(X) - 1, min=0).float())):
        raise RuntimeError("halo_exchange: the trimmed halo or the left neighbours differ")
    log("  halo_exchange on an 8-way x mesh: identity after trimming 2 columns, left "
        "neighbours with the edge repeated at x=0: exact")
    g = cut480.grid_desc
    hours = REGRID_HOURS
    src = np.asarray(cut480.data["wnd100m"][:hours])
    dst_x = np.arange(g.x[0] + 0.0625, g.x[-1], 0.125)
    dst_x = dst_x[:len(dst_x) - len(dst_x) % 4]
    dst_y = np.arange(g.y[0] + 0.0625, g.y[-1], 0.125)
    mesh = make_mesh(mesh_devices(N_SHARDS), t_axis=2)
    t0 = time.perf_counter()
    fn = sharded_regrid_bilinear(mesh, g.x, g.y, dst_x, dst_y)
    setup_s = time.perf_counter() - t0
    field = put_global(torch.as_tensor(src, device="cuda"), NamedSharding(mesh, field_spec()))
    out = fn(field).gather()
    ms = cuda_ms(lambda: fn(field), reps=5, warmup=1)
    t0 = time.perf_counter()
    serial = regrid(DataArray(src, coords={"time": g.time[:hours], "y": g.y, "x": g.x},
                              dims=("time", "y", "x")), dst_x, dst_y, resampling="bilinear")
    serial_s = time.perf_counter() - t0
    log(f"  sharded_regrid_bilinear, (t=2, x=4), {hours} h x {len(g.y)} x {len(g.x)} onto "
        f"{len(dst_y)} x {len(dst_x)} (0.125 deg): {ms:.3f} ms on {card} (CUDA events; "
        f"matrices {setup_s * 1e3:.1f} ms of host set-up); the serial regrid {serial_s:.3f} s "
        "on the host (float64)")
    err = within_max("sharded regrid vs serial", out.cpu().numpy(), serial.values, GRID_TOL)
    return {"name": "sharded_regrid_bilinear 0.125", "ms": ms, "serial_host_s": serial_s,
            "max_abs_err": err, "shape": list(out.shape), "card": card}


def banded_mesh_phase(cut480, matrix480, card):
    """16 (c): ``sharded_aggregate_banded`` of the 480-column wind field
    (MESH_HOURS h, NaN cells) with the (2048, C) region matrix on (t=2,
    x=4), against the unsharded banded route."""
    g = cut480.grid_desc
    Y, X = len(g.y), len(g.x)
    field = torch.as_tensor(np.asarray(cut480.data["wnd100m"][:MESH_HOURS]), device="cuda")
    rng = np.random.default_rng(16)
    field[torch.as_tensor(rng.integers(0, MESH_HOURS, 8)), torch.as_tensor(rng.integers(0, Y, 8)),
          torch.as_tensor(rng.integers(0, X, 8))] = float("nan")
    mesh = make_mesh(mesh_devices(N_SHARDS), t_axis=2)
    t0 = time.perf_counter()
    agg = sharded_aggregate_banded(mesh, matrix480, Y, X)
    setup_s = time.perf_counter() - t0
    fs = put_global(field, NamedSharding(mesh, field_spec()))
    out = agg(fs).gather()
    flat = field.reshape(MESH_HOURS, -1)
    closure = aggregate.spmm_closure(matrix480)
    want = closure(flat)
    ms = cuda_ms(lambda: agg(fs), reps=10)
    plain_ms = cuda_ms(lambda: closure(flat), reps=10)
    nb, W, route = aggregation_route(matrix480)
    b0 = agg.banded[0]
    log(f"  sharded_aggregate_banded, (t=2, x=4), ({matrix480.shape[0]}, {Y * X}) over "
        f"{MESH_HOURS} h: {ms:.3f} ms against the unsharded {route} route's {plain_ms:.3f} ms "
        f"(nb={nb}, W={W}) on {card}; each x block's bands nb={b0['nb']} W={b0['W']}, host "
        f"set-up {setup_s:.2f} s")
    err = within_max("sharded banded vs unsharded, NaN cells", out.cpu().numpy(),
                     want.cpu().numpy(), REL_TOL)
    return {"name": "sharded_aggregate_banded", "ms": ms, "unsharded_ms": plain_ms,
            "setup_s": setup_s, "max_abs_err": err, "card": card}


def sharded_cutout_phase(cut480, matrix480, card):
    """16 (d): ``cut.shard(mesh)``, then wind and PV with the region matrix,
    resident, against the same calls unsharded; wall s and idle share
    under torch.profiler; ``time_chunk`` must be refused."""
    names = [n for n in cut480.data if n != "runoff"]
    plain = sub_cutout(cut480, names, t1=MESH_HOURS, device="cuda")
    sharded = sub_cutout(cut480, names, t1=MESH_HOURS, device="cuda")
    mesh = make_mesh(mesh_devices(N_SHARDS))
    sharded.shard(mesh)
    calls = {"wind": lambda c: c.wind("Vestas_V112_3MW", matrix=matrix480, aggregate_time=None),
             "pv": lambda c: c.pv(panel="CSi", orientation="latitude_optimal",
                                  matrix=matrix480, aggregate_time=None)}
    entries, err = [], 0.0
    for name, fn in calls.items():
        walls = {}
        for label, c in (("unsharded", plain), ("sharded", sharded)):
            t0 = time.perf_counter()
            fn(c)
            torch.cuda.synchronize()
            cold = time.perf_counter() - t0
            res, wall, idle = timed_call(lambda: fn(c))
            walls[label] = (cold, wall, idle, res.values)
            where = (f"mesh t={mesh.shape['t']} x={mesh.shape['x']}" if label == "sharded"
                     else "one device")
            log(f"  {name} {label} ({where}): first call {cold:.3f} s (staging included), "
                f"again {wall:.3f} s, {trace_note(idle)}")
        err = max(err, within_max(f"{name} sharded vs unsharded", walls["sharded"][3],
                                  walls["unsharded"][3], REL_TOL))
        entries.append({"name": f"sharded cutout {name}", "card": card, "max_abs_err": err,
                        **{f"{k}_{m}": v for k, (c0, w, i, _) in walls.items()
                           for m, v in (("first_s", c0), ("wall_s", w),
                                        ("busy_ms", None if i is None else i[0]),
                                        ("idle", None if i is None else i[1]))}})
    try:
        sharded.wind("Vestas_V112_3MW", matrix=matrix480, aggregate_time=None, time_chunk=CHUNK)
    except ValueError as exc:
        log(f"  time_chunk on the sharded cutout refused: {exc}")
    else:
        raise RuntimeError("a sharded cutout streamed with time_chunk")
    del plain, sharded
    gc.collect()
    torch.cuda.empty_cache()
    return entries, err


def mesh_availability_phase(card):
    """16 (e): phase 15's case (b) through ``availabilitymatrix(...,
    mesh=)`` over N_SHARDS positions, against no mesh within 1e-6."""
    small = Cutout(module="synthetic", bounds=AVAIL_BOUNDS, time="2013-01-01")
    shapes = [box(x, y, x + 1.2, y + 1.3) for x in np.linspace(-4, 0.5, 5)[:4]
              for y in np.linspace(56, 61, 4)[:3]]
    x0, y0, x1, y1 = AVAIL_BOUNDS
    exc = excluder_of(landuse_3035([x0, x0, x1, x1], [y0, y1, y0, y1], 100.0), 3035, 100.0)()
    mesh = make_mesh(mesh_devices(N_SHARDS))
    t0 = time.perf_counter()
    one = small.availabilitymatrix(shapes, exc, backend="device").values
    one_s = time.perf_counter() - t0
    got, wall, idle = timed_call(lambda: small.availabilitymatrix(shapes, exc, backend="device",
                                                                  mesh=mesh).values)
    t0 = time.perf_counter()
    small.availabilitymatrix(shapes, exc, backend="device")
    warm_s = time.perf_counter() - t0
    diff = float(np.abs(got - one).max())
    log(f"  availabilitymatrix of (b), {len(shapes)} shapes padded to "
        f"{-(-len(shapes) // mesh.size) * mesh.size} over {mesh.size} positions: {wall:.3f} s "
        f"({trace_note(idle)}); no mesh {one_s:.3f} s cold, {warm_s:.3f} s warm; max abs diff "
        f"{diff:.3e} (tolerance 1e-6) on {card}")
    if not diff <= 1e-6:
        raise RuntimeError(f"availability over the mesh is {diff} from the one without")
    return {"name": "availability (b) over the mesh", "wall_s": wall, "one_device_cold_s": one_s,
            "one_device_warm_s": warm_s, "max_abs_diff": diff,
            "busy_ms": None if idle is None else idle[0],
            "idle": None if idle is None else idle[1], "card": card}


def two_process_phase(card):
    """16 (f): two processes over gloo sharing the card, 4 mesh positions
    each, on a small store under build/ (removed after): each reads its
    half of "t", runs its shards on the card and gathers the results,
    which must equal one process's (``core/multihost_worker.py``)."""
    t0 = time.perf_counter()
    results = _dryrun_multiprocess(N_SHARDS, 2, devices=mesh_devices(1), workdir=MESH_STORE)
    wall = time.perf_counter() - t0
    out = []
    for i, (rc, text) in enumerate(results):
        read = re.search(r"STORE OK \(read (\d+)/(\d+) bytes\)", text)
        log(f"  process {i}: exit {rc}, read {read.group(1)} of {read.group(2)} bytes of the "
            f"store; STEP, AGG, STORE and PIPELINE OK on {mesh_devices(1)[0]}")
        out.append({"process": i, "exit": rc, "bytes_read": int(read.group(1)),
                    "store_bytes": int(read.group(2))})
    if MESH_STORE.exists():
        raise RuntimeError(f"{MESH_STORE} was not removed")
    log(f"  two processes on {card}: {wall:.1f} s from start to the last exit")
    return {"name": "two processes sharing the card", "wall_s": wall, "workers": out,
            "card": card}


def multidevice_phase(cut, args, nan_args, card):
    """Phase 16: multiple devices on the card (see the module docstring)."""
    distinct = len(set(mesh_devices(N_SHARDS)))
    log(f"multiple devices on {card}: the mesh is the {torch.cuda.device_count()} visible "
        f"card(s) repeated to {N_SHARDS} positions, {distinct} distinct card(s) used")
    step_rows, base_ms, err = sharded_step_phase(args, nan_args, card)
    g = cut.grid_desc
    cut480 = Cutout(data={n: np.asarray(a)[..., :MESH_X] for n, a in cut.data.items()},
                    grid_desc=dataclasses.replace(g, x=g.x[:MESH_X]), attrs=dict(cut.attrs),
                    var_attrs=dict(cut.var_attrs))
    log(f"  the continental cut's first {MESH_X} of its {len(g.x)} columns (481 divide by no "
        f"mesh x): {cut480.shape[0]} x {cut480.shape[1]}")
    matrix480 = region_matrix(cut480, *CONT_REGIONS)
    entries = [halo_regrid_phase(cut480, card), banded_mesh_phase(cut480, matrix480, card)]
    cut_entries, cut_err = sharded_cutout_phase(cut480, matrix480, card)
    entries += cut_entries
    entries.append(mesh_availability_phase(card))
    entries.append(two_process_phase(card))
    return {"sharded_step": step_rows, "unsharded_step_ms": base_ms, "err": err,
            "distinct_cards": distinct, "entries": entries, "card": card}


# phase 17: ERA5-format files at the size of one monthly CDS request,
# written by the port's own encoders, through prepare to bus series on
# the card; a NetCDF cutout; a SARAH archive
INGEST_DIR = Path(__file__).resolve().parent / "build" / "ingest_phase"
# one monthly CDS request (era5.retrieval_times(monthly_requests=True)) is 30
# days; at 30 the phase took 458.5-581.8 s on the card's host in two runs
# (tools/ingest_probe.py --days 30), most of it host codecs that scale with the
# hours, so it is cut to 8 days to stay near 150 s
INGEST_DAYS = 8
INGEST_NBITS = 16           # GRIB simple packing, the width CDS ships ERA5 single levels in
NC_ENCODING = {"zlib": True, "complevel": 1, "shuffle": True}
NC_FILL = np.int16(-32767)
# the format of each feature's file (its variables: era5_raw)
INGEST_FORMATS = {"wind": "GRIB1", "influx": "NETCDF4", "temperature": "GRIB2",
                  "runoff": "GRIB2", "height": "GRIB1"}
INT16_REL = {"wind": {"max": 3e-3}, "pv": {"p999": 3e-3, "max": 2e-2}}  # phase 10's bounds
PV_INPUTS = ("influx_direct", "influx_diffuse", "influx_toa", "albedo", "temperature")
SARAH_BOX = (0.0, 10.0, 45.0, 55.0)  # x0, x1, y0, y1 at SARAH's 0.05 deg: 200 x 200 pixels
SARAH_DAY = "2013-06-21"
SARAH_SCALE = 0.05          # W/m2 a code, as the archive's int16 SIS/SID


def era5_raw(cut, feature, hours):
    """{shortName: float64 (T, Y, X) or (Y, X)} of the raw ERA5 variables
    whose derivations give the cut's fields (ascending y): u/v from speed
    and azimuth, 10 m through the shear exponent, the accumulations in J
    m**-2 over the hour (soil temperature keeps the cut's NaN over the
    sea, as ERA5's land fields), geopotential from height."""
    def f(name):
        a = cut.data[name]
        return np.asarray(a[:hours] if np.ndim(a) == 3 else a, dtype=np.float64)

    if feature == "wind":
        w, az = f("wnd100m"), f("wnd_azimuth")
        w10 = w * 0.1 ** f("wnd_shear_exp")
        return {"u100": w * np.sin(az), "v100": w * np.cos(az), "u10": w10 * np.sin(az),
                "v10": w10 * np.cos(az), "fsr": f("roughness")}
    if feature == "influx":
        direct, diffuse = f("influx_direct"), f("influx_diffuse")
        ssrd = (direct + diffuse) * 3600.0
        return {"ssrd": ssrd, "ssr": ssrd * (1.0 - f("albedo")),
                "tisr": f("influx_toa") * 3600.0, "fdir": direct * 3600.0}
    if feature == "temperature":
        return {"t2m": f("temperature"), "stl4": f("soil temperature"),
                "d2m": f("dewpoint temperature")}
    if feature == "runoff":
        return {"ro": f("runoff")}
    return {"z": f("height") * era5_module.G0}


def grib_half_steps(a, edition):
    """(T,) bound on |decoded - encoded| of each message of ``a`` (T, Y,
    X), worked out from its simple packing as the encoder chooses it: half
    the binary step 2**E (the range over 2**16 - 1 codes), plus what the
    reference value loses to its own format (IBM 32-bit in GRIB1, IEEE
    float32 in GRIB2: values below it clip to code 0), plus float64
    rounding of ref + code * 2**E."""
    flat = a.reshape(len(a), -1)
    vmin, vmax = np.nanmin(flat, axis=1), np.nanmax(flat, axis=1)
    out = np.empty(len(a))
    for t, (lo, hi) in enumerate(zip(vmin, vmax)):
        e = int(np.ceil(np.log2((hi - lo) / (2**INGEST_NBITS - 1)))) if hi > lo else 0
        ref = (grib._ibm32_decode(grib._ibm32_encode(lo)) if edition == 1
               else float(np.float32(lo)))
        out[t] = 2.0**e / 2 + abs(ref - lo) + 4 * np.finfo(float).eps * max(abs(lo), abs(hi))
    return out


def write_grib(path, raw, lats, lons, times, edition):
    """GRIB messages hour by hour, latitude descending as CDS delivers;
    accumulated runoff as an interval product (template 4.8 in GRIB2).
    Returns {short: (T,) half-step bounds}, the message count."""
    encode = grib.encode_grib1 if edition == 1 else grib.encode_grib2
    n = 0
    with open(path, "wb") as fh:
        for t in range(len(times)):
            recs = []
            for short, a in raw.items():
                rec = {"shortName": short, "values": (a[t] if a.ndim == 3 else a)[::-1],
                       "lats": lats[::-1], "lons": lons, "valid_time": times[t],
                       "nbits": INGEST_NBITS}
                if short == "ro" and edition == 2:
                    rec["interval_hours"] = 1
                recs.append(rec)
            fh.write(encode(recs))
            n += len(recs)
    return {s: grib_half_steps(a if a.ndim == 3 else a[None], edition)
            for s, a in raw.items()}, n


def write_cds_netcdf(path, raw, lats, lons, times):
    """The classic CDS NetCDF: valid_time/latitude (descending)/longitude,
    each variable int16 with scale_factor and add_offset over its range
    (65532 steps, the offset at its centre) and _FillValue, zlib with
    shuffle.  The offset is summed as lo + 32766 * scale, so that code
    -32766 decodes to lo exactly: a dark hour's 0 J stays 0 (else the
    albedo (ssrd - ssr) / ssrd of night hours is a ratio of two rounding
    residues).  Returns {short: half-step bound} (a scalar a variable)."""
    variables = {"valid_time": (("valid_time",), times, {"standard_name": "time"}),
                 "latitude": (("latitude",), lats[::-1], {"units": "degrees_north"}),
                 "longitude": (("longitude",), lons, {"units": "degrees_east"})}
    bounds = {}
    for short, a in raw.items():
        lo, hi = float(np.nanmin(a)), float(np.nanmax(a))
        scale = (hi - lo) / 65532 if hi > lo else 1.0
        offset = lo + 32766 * scale
        codes = np.rint((a[:, ::-1] - offset) / scale)
        codes[np.isnan(codes)] = NC_FILL
        variables[short] = (("valid_time", "latitude", "longitude"), codes.astype(np.int16),
                            {"scale_factor": scale, "add_offset": offset, "_FillValue": NC_FILL,
                             "units": "J m**-2"})
        bounds[short] = scale / 2 + 4 * np.finfo(float).eps * max(abs(lo), abs(hi))
    ncio.write_netcdf(path, {"valid_time": len(times), "latitude": len(lats),
                             "longitude": len(lons)}, variables,
                      {"Conventions": "CF-1.7", "institution": "ECMWF"}, format="NETCDF4",
                      complevel=NC_ENCODING["complevel"], shuffle=NC_ENCODING["shuffle"])
    return bounds


class PeakRSS:
    """Peak resident set of this process over a block, sampled every 20 ms
    from /proc/self/statm (the kernel's high-water mark covers the whole
    process, and writing clear_refs to reset it is refused on the card's
    machine); ``start`` is the resident set on entry."""

    def __enter__(self):
        self.start = self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    @staticmethod
    def _rss():
        with open("/proc/self/statm", encoding="utf-8") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def _run(self):
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())
        return False


ERA5_DERIVE = {
    "wind": lambda s, g: era5_module.sanitize_wind(era5_module.derive_wind(
        s["u100"], s["v100"], s["u10"], s["v10"], s["fsr"])),
    "influx": lambda s, g: era5_module.sanitize_influx(era5_module.derive_influx(
        s["ssrd"], s["ssr"], s["tisr"], s["fdir"], g.time_index, g.x, g.y)),
    "temperature": lambda s, g: {"temperature": s["t2m"], "soil temperature": s["stl4"],
                                 "dewpoint temperature": s["d2m"]},
    "runoff": lambda s, g: era5_module.sanitize_runoff({"runoff": s["ro"]}),
    "height": lambda s, g: {"height": era5_module.derive_height(s["z"])},
}


def check_decoded(feature, raw, decoded, coords, bounds):
    """Raise unless every decoded field lies within its half step of the
    encoded field, NaN masks equal, y ascending; returns the worst
    |decoded - encoded| / bound."""
    y = coords["y"]
    if not (np.diff(y) > 0).all():
        raise RuntimeError(f"{feature}: decoded y is not ascending")
    worst = 0.0
    for short, a in raw.items():
        got = decoded[short][0] if a.ndim == 2 else decoded[short]
        if got.shape != a.shape or not np.array_equal(np.isnan(got), np.isnan(a)):
            raise RuntimeError(f"{feature} {short}: shape {got.shape} or NaN mask differs")
        b = np.asarray(bounds[short])
        b = b.reshape((-1,) + (1,) * (a.ndim - 1)) if b.ndim else b
        if a.ndim == 2:
            b = b[0]
        ratio = np.nanmax(np.abs(got - a) / b)
        if not ratio <= 1.0:
            raise RuntimeError(f"{feature} {short}: decoded {ratio:.4f} half steps away")
        worst = max(worst, float(ratio))
    return worst


def check_derived(feature, era, decoded, coords):
    """Raise unless the store's variables of ``feature`` equal the era5
    derivations applied to the decoded raw arrays, bit for bit, in the
    store's dtype."""
    g = era.grid_desc
    shorts = era5_module.FEATURE_SHORTNAMES[feature]
    if feature in era5_module.static_features:
        sub = {k: era5_module._align_static(decoded[k], coords, g) for k in shorts}
    else:
        sub = era5_module._align({k: decoded[k] for k in shorts}, coords, g)
    for name, arr in ERA5_DERIVE[feature](sub, g).items():
        want = np.asarray(arr).astype(era.dtype)
        if not np.array_equal(np.asarray(era.data[name]), want, equal_nan=True):
            raise RuntimeError(f"{feature}: stored {name!r} differs from the derivation of "
                               "the decoded arrays")


def wind_interval_bound(syn, bounds, turbine):
    """(T, C) bound on |capacity factor| differences a cell-hour between
    the ERA5 cutout and the synthetic one it was encoded from: the
    decoded 100 m speed lies within hypot(du, dv) of the encoded one (plus
    its float32 rounding), the roughness within its half step (a negative
    one sanitized to 2e-4); the hub speed w * log(h/z0) / log(100/z0)
    then lies between the corners of that box (monotone in both), widened
    by 1e-6 for float32 arithmetic, and the power curve's range over that
    interval (its ends and every knot inside, the cut-out jump included)
    bounds the change of the capacity factor.  (The synthetic roughness
    is at least 2e-4, so the sanitizer's floor lies inside [z0 - dz, z0 +
    dz] wherever that interval reaches 0.)"""
    dev = syn.device
    w, z = (torch.as_tensor(np.asarray(syn.data[k]), device=dev).double()
            for k in ("wnd100m", "roughness"))
    T = w.shape[0]
    du, dv, dz = (torch.as_tensor(bounds[s], device=dev).view(T, 1, 1)
                  for s in ("u100", "v100", "fsr"))
    ulp = 2.0 ** -23
    dw = torch.hypot(du, dv) + ulp * w
    dzz = dz + ulp * z
    h = float(turbine["hub_height"])

    def factor(zz):
        return torch.log(h / zz) / torch.log(100.0 / zz)

    fa, fb = factor((z - dzz).clamp(min=1e-12)), factor(z + dzz)
    f_min, f_max = torch.minimum(fa, fb), torch.maximum(fa, fb)
    v_lo = (w - dw).clamp(min=0.0) * f_min * (1 - 1e-6)
    v_hi = (w + dw) * f_max * (1 + 1e-6)
    V = torch.as_tensor(np.asarray(turbine["V"], dtype=np.float64), device=dev)
    P = torch.as_tensor(np.asarray(turbine["POW"], dtype=np.float64) / turbine["P"],
                        device=dev)
    p_lo = wind_physics.power_curve(v_lo, V, P, 1.0)
    p_hi = wind_physics.power_curve(v_hi, V, P, 1.0)
    top, bottom = torch.maximum(p_lo, p_hi), torch.minimum(p_lo, p_hi)
    for vk, pk in zip(V.tolist(), P.tolist()):
        inside = (v_lo <= vk) & (vk <= v_hi)
        top = torch.where(inside, torch.clamp(top, min=pk), top)
        bottom = torch.where(inside, torch.clamp(bottom, max=pk), bottom)
    return (top - bottom).reshape(T, -1).cpu().numpy()


def pv_first_order_bound(syn, deltas, night_lift):
    """(T, C) first-order bound on PV capacity-factor differences a
    cell-hour: for each input the larger response to shifting it alone by
    +-its quantization bound (on the card, the solar angles unchanged),
    summed over the inputs and doubled for their cross terms.  Albedo's
    response is taken with the night's irradiance lifted by its own bound
    (``night_lift``): the synthetic night is dark, the decoded one may
    hold a half step of light for albedo to reflect."""
    cache = syn.fields()
    kw = dict(panel="CSi", orientation="latitude_optimal", aggregate_time=None)

    def run():
        return np.asarray(syn.pv(**kw).values, dtype=np.float64)

    base = run()
    total = np.zeros_like(base)
    for name in PV_INPUTS:
        lifted = {k: cache[k] for k in night_lift} if name == "albedo" else {}
        for k in lifted:
            cache[k] = lifted[k] + night_lift[k]
        ref = run() if lifted else base
        orig = cache[name]
        resp = np.zeros_like(base)
        for sign in (1.0, -1.0):
            cache[name] = orig + sign * deltas[name]
            resp = np.maximum(resp, np.abs(run() - ref))
        cache[name] = orig
        cache.update(lifted)
        total += resp
    T = base.shape[0]
    return 2.0 * total.reshape(T, -1)


def pv_deltas(syn, bounds):
    """({PV input: (T, Y, X) float32 tensor on the card} of each input's
    quantization bound, the night lift): the NetCDF accumulations' half
    steps over 3600 s, temperature's GRIB2 half step of its hour, albedo's
    through (ssrd - ssr) / ssrd where ssrd exceeds twice its half step
    (elsewhere, at night, 1), each with its float32 rounding; the lift is
    direct and diffuse's bounds where it is night."""
    f = syn.fields()
    T = f["temperature"].shape[0]
    ulp = 2.0 ** -23
    d = {"influx_direct": bounds["fdir"] / 3600 + ulp * f["influx_direct"].abs(),
         "influx_diffuse": (bounds["ssrd"] + bounds["fdir"]) / 3600
         + ulp * f["influx_diffuse"].abs(),
         "influx_toa": bounds["tisr"] / 3600 + ulp * f["influx_toa"].abs(),
         "temperature": torch.as_tensor(bounds["t2m"], dtype=torch.float32,
                                        device=syn.device).view(T, 1, 1)
         + ulp * f["temperature"].abs()}
    s = (f["influx_direct"] + f["influx_diffuse"]).double() * 3600
    n = s * (1 - f["albedo"].double())
    bs, bn = bounds["ssrd"], bounds["ssr"]
    lit = s > 2 * bs
    alb = (s * bn + n.abs() * bs) / (s * (s - bs))
    d["albedo"] = torch.where(lit, alb + ulp, torch.ones_like(alb)).float()
    night = (~lit).float()
    return d, {k: d[k] * night for k in ("influx_direct", "influx_diffuse")}


def aggregate_bound(matrix, cell_bound):
    """(B, T) bound of the aggregated series from a (T, C) bound a cell:
    sum_c |M[b, c]| * bound[t, c]."""
    return np.asarray(abs(matrix).astype(np.float64) @ cell_bound.T)


def sarah_phase(matrix_shape=(4, 4)):
    """17 (f): a SARAH archive of SIS/SID NETCDF4 files (0.05 deg over a
    10 x 10 deg box, one day of half-hourly steps, int16 with fill codes
    at NaN gaps), prepared with the synthetic module's temperature and
    albedo onto a 0.25 deg cutout (regridded), PV on the card against the
    CPU.  Returns its entry."""
    x0, x1, y0, y1 = SARAH_BOX
    lon = np.round(np.arange(x0 + 0.025, x1, 0.05), 4)  # pixel centres
    lat = np.round(np.arange(y0 + 0.025, y1, 0.05), 4)
    times = np.datetime64(SARAH_DAY, "ns") + np.arange(48) * np.timedelta64(30, "m")
    fields = synthetic.generate("influx", lon, lat, times, seed=17)
    direct, diffuse = fields["influx_direct"][1], fields["influx_diffuse"][1]
    rng = np.random.default_rng(17)
    gaps = rng.random(direct.shape) < 0.02
    gaps[14:16, 50:80, 50:80] = True  # a dawn-time hole over a block
    d = INGEST_DIR / "sarah"
    d.mkdir(parents=True, exist_ok=True)
    minutes = (times - times[0]) / np.timedelta64(1, "m")
    t0 = time.perf_counter()
    nbytes = 0
    for var, vals in (("SIS", direct + diffuse), ("SID", direct)):
        codes = np.rint(vals / SARAH_SCALE)
        codes[gaps] = -1
        path = d / f"{var}in{SARAH_DAY.replace('-', '')}0000004UD1000101UD.nc"
        ncio.write_netcdf(path, {"time": 48, "lat": len(lat), "lon": len(lon)}, {
            "time": (("time",), minutes, {"units": f"minutes since {SARAH_DAY} 00:00:00"}),
            "lat": (("lat",), lat, {}), "lon": (("lon",), lon, {}),
            var: (("time", "lat", "lon"), codes.astype(np.int16),
                  {"scale_factor": SARAH_SCALE, "_FillValue": np.int16(-1), "units": "W m-2"})},
            format="NETCDF4", complevel=NC_ENCODING["complevel"], shuffle=True)
        nbytes += path.stat().st_size
    write_s = time.perf_counter() - t0
    # 0.25 deg cells whose edges lie inside the box: (x1 - x0) / 0.25 - 2 a side
    kw = dict(module=["sarah", "synthetic"], sarah_dir=str(d), x=slice(x0 + 0.25, x1 - 0.25),
              y=slice(y0 + 0.25, y1 - 0.25), dx=0.25, dy=0.25, time=SARAH_DAY)
    side = (round((x1 - x0) / 0.25) - 1, round((y1 - y0) / 0.25) - 1)
    t0 = time.perf_counter()
    sc = Cutout(**kw).prepare(features=["influx", "temperature"])
    prep_s = time.perf_counter() - t0
    if sc.shape != side[::-1] or not np.isfinite(sc.data["influx_direct"]).all():
        raise RuntimeError(f"sarah cutout {sc.shape}, finite "
                           f"{np.isfinite(sc.data['influx_direct']).all()}")
    m = region_matrix(sc, *matrix_shape)
    cpu = Cutout(data=sc.data, grid_desc=sc.grid_desc, attrs=sc.attrs, var_attrs=sc.var_attrs,
                 device="cpu")
    call = dict(panel="CSi", orientation="latitude_optimal", matrix=m, aggregate_time=None)
    res, wall, idle = timed_call(lambda: sc.pv(**call))
    log(f"  (f) SARAH: {nbytes / 1e6:.1f} MB of SIS/SID NETCDF4 written in "
        f"{write_s:.2f} s (0.05 deg, {len(lat)} x {len(lon)} pixels, 48 half hours, "
        f"{int(gaps.sum())} NaN gaps); prepare onto {sc.shape} at 0.25 deg (regridded, "
        f"interpolated, hourly; temperature and albedo from the synthetic module) "
        f"{prep_s:.2f} s; pv with a {m.shape[0]}-region matrix {wall:.3f} s on the card "
        f"({trace_note(idle)})")
    err = check_close("sarah pv card vs CPU", res.values, cpu.pv(**call).values,
                      (("p999", REL_TOL), ("max", 2e-2)))
    return {"name": "sarah pv", "files_MB": nbytes / 1e6, "write_s": write_s,
            "prepare_s": prep_s, "wall_s": wall, "idle": idle and idle[1],
            "max_abs_err_cpu": err}


def ingest_phase(cut, matrix, card, in_memory):
    """Phase 17: ERA5-format files from the cut's first INGEST_DAYS days
    through ``Cutout(..., module="era5")`` and ``prepare`` into an .atc
    store, checked against what was encoded; wind and PV from the store on
    the card against the CPU and against phase 10's series; the prepared
    cutout through a NetCDF file; a SARAH archive.  Returns the ingest
    line's entries."""
    hours = 24 * INGEST_DAYS
    g = cut.grid_desc
    Y, X = cut.shape
    C, B = Y * X, matrix.shape[0]
    times = g.time[:hours]
    if INGEST_DIR.exists():
        shutil.rmtree(INGEST_DIR)
    INGEST_DIR.mkdir(parents=True)
    entries = []
    log(f"ingest phase on {card}: ERA5-format files for {hours} h ({INGEST_DAYS} days, cut "
        f"from the 30 of one monthly CDS request to keep the phase near 150 s; "
        f"{len(era5_module.retrieval_times(times, monthly_requests=True))} query of "
        f"retrieval_times) on the continental grid {Y} x {X} (dx {g.dx:.4f}, dy {g.dy:.4f} "
        f"deg), into {INGEST_DIR} ({fs_type(INGEST_DIR)})")
    end = str(np.datetime64(times[-1], "D"))
    store_path = INGEST_DIR / "era5.atc"
    era = Cutout(store_path, module="era5",
                 **continental_kw(slice(str(np.datetime64(times[0], "D")), end)))
    if not (np.array_equal(era.grid_desc.x, g.x) and np.array_equal(era.grid_desc.y, g.y)
            and np.array_equal(era.grid_desc.time, times)):
        raise RuntimeError("the era5 cutout's grid is not the cut's")
    bounds = {}
    real_open = era5_module._open_raw
    t_part = time.perf_counter()
    try:
        for feature, fmt in INGEST_FORMATS.items():
            # (a) the file
            raw = era5_raw(cut, feature, hours)
            path = INGEST_DIR / f"{feature}.{'nc' if fmt == 'NETCDF4' else 'grib'}"
            t0 = time.perf_counter()
            if fmt == "NETCDF4":
                fb = write_cds_netcdf(path, raw, g.y, g.x, times)
                n_msg = None
            else:
                ftimes = times[:1] if feature == "height" else times
                fb, n_msg = write_grib(path, raw, g.y, g.x, ftimes, 1 if fmt == "GRIB1" else 2)
            write_s = time.perf_counter() - t0
            bounds.update(fb)
            size = path.stat().st_size
            # (b) prepare, the decode timed inside it
            calls = []

            def timed_open(p):
                t1 = time.perf_counter()
                out = real_open(p)
                calls.append((time.perf_counter() - t1, out))
                return out

            era5_module._open_raw = timed_open
            torch.cuda.synchronize()
            with profiled() as prof, PeakRSS() as rss:
                t0 = time.perf_counter()
                era.prepare(features=[feature], era5_files=str(path))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            era5_module._open_raw = real_open
            idle = device_idle(prof, wall * 1e3)
            (decode_s, (decoded, coords)), = calls
            values = sum(a.size for a in raw.values())
            # (c) checks
            t0 = time.perf_counter()
            worst = check_decoded(feature, raw, decoded, coords, fb)
            check_derived(feature, era, decoded, coords)
            check_s = time.perf_counter() - t0
            log(f"  {feature}: {fmt} {size / 1e6:.1f} MB"
                + (f" ({n_msg} messages of {INGEST_NBITS}-bit simple packing)" if n_msg else
                   f" (int16 CF packing, zlib level {NC_ENCODING['complevel']} with shuffle, "
                   "latitude descending)")
                + f" written in {write_s:.2f} s; prepare {wall:.2f} s, of which decode "
                f"{decode_s:.2f} s = {size / decode_s / 1e6:.1f} MB/s of file, "
                f"{values / decode_s / 1e6:.1f} M values/s; "
                + ("the trace holds no device record: the card idle all the call (idle share "
                   "1, as expected of host work)" if idle is None else
                   f"device busy {idle[0]:.1f} ms, idle share {idle[1]:.3f}")
                + f"; peak host memory {rss.peak / 1e9:.2f} GB ({(rss.peak - rss.start) / 1e9:.2f}"
                " GB above the process's on entry, sampled every 20 ms)"
                + f"; checks {check_s:.2f} s: decoded within {worst:.3f} of a half step of what "
                f"was encoded, NaN masks equal, y ascending; the store's "
                f"{len(era5_module.features[feature])} variables equal the derivations of the "
                "decoded arrays bit for bit")
            entries.append({"name": f"prepare {feature}", "format": fmt, "file_MB": size / 1e6,
                            "messages": n_msg, "write_s": write_s, "wall_s": wall,
                            "decode_s": decode_s, "decode_MB_per_s": size / decode_s / 1e6,
                            "decode_Mvalues_per_s": values / decode_s / 1e6,
                            "idle": 1.0 if idle is None else idle[1],
                            "peak_host_GB": rss.peak / 1e9,
                            "peak_above_entry_GB": (rss.peak - rss.start) / 1e9,
                            "check_s": check_s, "worst_half_steps": worst})
            del raw, decoded, coords, calls
            gc.collect()
    finally:
        era5_module._open_raw = real_open
    era = Cutout(store_path)
    if not era.prepared:
        raise RuntimeError("the era5 store is not prepared")
    log(f"  (a)-(c): {time.perf_counter() - t_part:.1f} s")

    # (d) wind and PV from the store on the card
    t_part = time.perf_counter()
    stage_all(era)
    torch.cuda.synchronize()
    log(f"  (d) resident staging from the store's memory maps: {time.perf_counter() - t_part:.2f}"
        " s (set-up)")
    nb, W = banded_width(matrix)
    band_flops = 2 * nb * 128 * W * hours
    # the streamed calls stage the whole span as one chunk
    modes = {"resident": CONT_MODES["resident"],
             "streamed int16": dict(CONT_MODES["streamed int16"], time_chunk=hours)}
    windows = [(0, hours)]
    runs = continental_runs(era, matrix)
    runs["pv"](time_chunk=hours)  # set-up: the pinned buffers
    out, call_entry = {}, {}
    for mode, kw in modes.items():
        for name, fn in runs.items():
            r = timed_mode(name, f"{mode} (era5)", fn, kw, (B, hours, C), windows, band_flops)
            out[name, mode] = r["vals"]
            call_entry[name, mode] = {"name": f"era5 {name}", "mode": mode, "wall_s": r["wall"],
                                      "idle": r["idle"] and r["idle"][1]}
            entries.append(call_entry[name, mode])
    log("  (d) the first 48 h against the plain path on the CPU:")
    sub = era.isel_time(0, 48)
    cpu = Cutout(data=sub.data, grid_desc=sub.grid_desc, attrs=sub.attrs,
                 var_attrs=sub.var_attrs, device="cpu")
    cpu_runs = continental_runs(cpu, matrix)
    for (name, mode), vals in out.items():
        kw = dict(modes[mode], time_chunk=24) if "int16" in mode else {}
        want = cpu_runs[name](**kw).values
        bnds = ((("max", REL_TOL),) if name == "wind" else
                (("p999", REL_TOL), ("max", 2e-2)))
        call_entry[name, mode]["max_abs_err_cpu"] = check_close(f"{name} {mode}", vals[:, :48],
                                                                want, bnds)
    for name in runs:
        res = out[name, "resident"]
        scale = float(np.abs(res).max())
        diff = np.abs(out[name, "streamed int16"] - res)
        stats = {"max": diff.max(), "p999": np.quantile(diff, 0.999)}
        log(f"  {name}: int16 vs resident max {stats['max']:.3e}, p999 {stats['p999']:.3e} "
            f"(max |resident| {scale:.4g})")
        for stat, rel in INT16_REL[name].items():
            if not stats[stat] < rel * scale:
                raise RuntimeError(f"{name}: int16 vs resident {stat} {stats[stat]} above "
                                   f"{rel} * {scale}")

    log("  (d) against phase 10's series of the synthetic cut, by a bound from the "
        f"{INGEST_NBITS}-bit quantization:")
    names = sorted(cut.data)
    syn = sub_cutout(cut, names, t1=hours, device=era.device)
    for k in ("solar_altitude", "solar_azimuth"):
        if not np.array_equal(np.asarray(era.data[k]), np.asarray(syn.data[k])):
            raise RuntimeError(f"{k}: the era5 derivation differs from the synthetic field")
    turbine = get_windturbineconfig("Vestas_V112_3MW", add_cutout_windspeed=False)
    t0 = time.perf_counter()
    cell = {"wind": wind_interval_bound(syn, bounds, turbine),
            "pv": pv_first_order_bound(syn, *pv_deltas(syn, bounds))}
    del syn
    torch.cuda.empty_cache()
    log(f"    bounds computed in {time.perf_counter() - t0:.1f} s")
    for name in runs:
        want = in_memory[name, "resident"][:, :hours]
        slack = REL_TOL * float(np.abs(want).max())
        bound = aggregate_bound(matrix, cell[name]) + slack
        diff = np.abs(out[name, "resident"] - want)
        ratio = float((diff / bound).max())
        log(f"    {name}: max |era5 - synthetic| {diff.max():.4e}, bound max "
            f"{bound.max():.4e}, median {np.median(bound):.4e}; worst diff / bound "
            f"{ratio:.4f}" + (" (interval bound: rigorous)" if name == "wind" else
                             " (first-order bound, doubled)")
            + f"; float32 slack {slack:.3e} (1e-5 * max)")
        if not ratio <= 1.0:
            raise RuntimeError(f"{name}: era5 vs synthetic {ratio} of the bound")
        call_entry[name, "resident"]["vs_synthetic"] = {
            "max_diff": float(diff.max()), "bound_max": float(bound.max()), "worst_ratio": ratio}

    log(f"  (d): {time.perf_counter() - t_part:.1f} s")

    # (e) the prepared cutout through a NetCDF file
    nc_path = INGEST_DIR / "era5.nc"
    nbytes = sum(np.asarray(a).nbytes for a in era.data.values())
    t0 = time.perf_counter()
    era.to_netcdf(nc_path, compression=NC_ENCODING)
    write_s = time.perf_counter() - t0
    size = nc_path.stat().st_size
    t0 = time.perf_counter()
    nc = Cutout(nc_path)
    open_s = time.perf_counter() - t0
    for k, a in era.data.items():
        if not np.array_equal(np.asarray(nc.data[k]), np.asarray(a), equal_nan=True):
            raise RuntimeError(f"{k}: the NetCDF cutout's field differs from the store's")
    again = continental_runs(nc, matrix)["wind"](**CONT_MODES["resident"]).values
    if not np.array_equal(again, out["wind", "resident"]):
        raise RuntimeError("wind from the NetCDF cutout differs from (d)'s")
    log(f"  (e) to_netcdf: {nbytes / 1e9:.3f} GB of fields in {write_s:.2f} s = "
        f"{nbytes / write_s / 1e9:.3f} GB/s (zlib level {NC_ENCODING['complevel']}, shuffle; "
        f"{size / 1e9:.3f} GB file); Cutout(.nc) read and decoded in {open_s:.2f} s = "
        f"{nbytes / open_s / 1e9:.3f} GB/s; every field and the wind series equal (d)'s bit "
        "for bit")
    entries.append({"name": "to_netcdf", "GB": nbytes / 1e9, "file_GB": size / 1e9,
                    "s": write_s, "GB_per_s": nbytes / write_s / 1e9, "reopen_s": open_s,
                    "reopen_GB_per_s": nbytes / open_s / 1e9})
    del nc, era, again
    gc.collect()
    entries.append(sarah_phase())
    shutil.rmtree(INGEST_DIR, ignore_errors=True)
    return entries



# ---------------------------------------------------------------------------
# phase 18: a full year on the card
# ---------------------------------------------------------------------------
# (a) the BASELINE.md gates of tests/test_fullyear.py: literals, so that no
# JAX is needed here
YEAR_GATES_KW = dict(module="synthetic", x=slice(-4, 3.75), y=slice(50, 55.75), time="2013",
                     dtype="float64")
YEAR_PINS = {"wind annual CF (Vestas_V112_3MW)": 0.511356830734,
             "PV annual CF (CSi, latitude_optimal)": 0.163772480245,
             "heat demand, sum of the 365 days": 3.3901346450e6,
             "runoff normalized to 5000 over 2013": 5000.0}
PIN_RTOL = 1e-6
# (b) a year at the bench grid, 96 x 128 cells of 0.25 deg (bench.py's
# shape, on the 0.25 deg lattice from bench.py's south-west corner), 20
# regions, streamed a month at a time
YEAR_BOX = dict(x=slice(-12, 19.75), y=slice(35, 58.75))
YEAR_GRID = (96, 128)
YEAR_CHUNK = 730
YEAR_REGIONS = (4, 5)
RUNOFF_TOTAL = 5000.0  # a year's runoff a region, for normalize_using_yearly
EXAMPLES_DIR = Path(__file__).resolve().parent / "examples_torch"
# (d) cells of the bench fields: all 96 x 128, and the first 12,255 (no
# multiple of 4); bus counts of both bus tiles
ROW_PHASE_CELLS = (12288, 12255)
ROW_PHASE_BUSES = (20, 34)


def oedb_rows():
    """Rows of a stub OEDB turbine library: the registry's Vestas V112 3MW
    (its curve in kW, its hub height), a second turbine and one without a
    power curve."""
    conf = resource.load_yaml(resource.windturbines["Vestas_V112_3MW"])
    kw = [f"{float(p) * 1e3:.10g}" for p in conf["POW"]]
    if not np.array_equal(np.array(json.loads("[" + ", ".join(kw) + "]")) / 1e3,
                          np.array(conf["POW"], dtype=float)):
        raise RuntimeError("the kW curve does not give the registry's MW curve back")
    return [
        {"id": 1, "name": "V112", "turbine_type": "V112/3000", "manufacturer": "Vestas",
         "has_power_curve": True, "power_curve_wind_speeds": json.dumps(
             [float(v) for v in conf["V"]]), "power_curve_values": "[" + ", ".join(kw) + "]",
         "hub_height": f"{conf['HUB_HEIGHT']:g}", "source": "the registry's datasheet curve"},
        {"id": 2, "name": "E-101", "turbine_type": "E-101/3050", "manufacturer": "Enercon",
         "has_power_curve": True, "power_curve_wind_speeds": "[3, 6, 9, 12, 25]",
         "power_curve_values": "[0, 500, 2000, 3050, 3050]", "hub_height": "99;135",
         "source": "stub"},
        {"id": 3, "name": "NoCurve", "turbine_type": "X", "manufacturer": "Y",
         "has_power_curve": False, "power_curve_wind_speeds": None,
         "power_curve_values": None, "hub_height": "100", "source": "stub"},
    ]


class StubRequests:
    """``requests`` in ``sys.modules`` for a block: a module whose ``get``
    answers with ``rows`` and counts its calls, so that the OEDB search runs
    its real fetch, filter, cache and registry code with nothing sent out;
    the previous module (or its absence) and the search's cache come back
    after."""

    def __init__(self, rows):
        self.rows, self.calls = rows, []

    def __enter__(self):
        rows, calls = self.rows, self.calls

        class Response:
            def json(self):
                return [dict(r) for r in rows]

        def get(url, **kw):
            calls.append(url)
            return Response()

        self.stub = type(sys)("requests")
        self.stub.get = get
        self.saved = sys.modules.get("requests")
        sys.modules["requests"] = self.stub
        resource._oedb_turbines = None
        return self

    def __exit__(self, *exc):
        if self.saved is None:
            sys.modules.pop("requests", None)
        else:
            sys.modules["requests"] = self.saved
        resource._oedb_turbines = None
        return False


def year_gates(card):
    """18 (a): tests/test_fullyear.py's pinned numbers on a float64 year on
    the card; returns {name: (got, want)}."""
    t0 = time.perf_counter()
    c = Cutout(**YEAR_GATES_KW).prepare()
    T, (Y, X) = len(c.grid_desc.time), c.shape
    log(f"  (a) BASELINE.md's gates: synthetic 2013, {T} h x {Y} x {X} cells, float64, on "
        f"{card}; prepared on the host in {time.perf_counter() - t0:.1f} s")
    if (T, Y, X) != (8760, 24, 32) or c.fields()["wnd100m"].device.type != "cuda":
        raise RuntimeError(f"the gates' year is {(T, Y, X)} on {c.fields()['wnd100m'].device}")
    t0 = time.perf_counter()
    wind = c.wind("Vestas_V112_3MW", aggregate_time=None).values
    pv = c.pv(panel="CSi", orientation="latitude_optimal", aggregate_time=None).values
    hd = c.heat_demand(aggregate_time=None)
    runoff = c.runoff(layout=c.uniform_layout(), normalize_using_yearly={2013: {0: RUNOFF_TOTAL}},
                      aggregate_time=None).values
    monthly_cf = c.wind("Vestas_V112_3MW", layout=c.uniform_layout(), per_unit=True,
                        aggregate_time=None)
    months = monthly_cf.coords["time"].astype("datetime64[M]")
    monthly = np.array([monthly_cf.values[0, months == m].mean() for m in np.unique(months)])
    torch.cuda.synchronize()
    got = dict(zip(YEAR_PINS, (float(wind.mean()), float(pv.mean()), float(hd.values.sum()),
                               float(runoff.sum()))))
    for name, want in YEAR_PINS.items():
        ok = abs(got[name] - want) <= PIN_RTOL * abs(want)
        log(f"    {name}: {got[name]:.12g} against {want:.12g} (rtol {PIN_RTOL}): "
            f"{'held' if ok else 'NOT HELD'}")
        if not ok:
            raise RuntimeError(f"full-year gate {name}: {got[name]} against {want}")
    if hd.sizes["time"] != 365 or len(monthly) != 12 or not (0 < monthly.min() < monthly.max() < 1):
        raise RuntimeError(f"heat demand days {hd.sizes['time']}, monthly means {monthly}")
    log(f"    365 heat-demand days; 12 monthly wind means in (0, 1): {np.round(monthly, 4)}; "
        f"the five conversions took {time.perf_counter() - t0:.2f} s")
    return {k: (got[k], YEAR_PINS[k]) for k in YEAR_PINS}


def year_call(label, fn, kw, cells, windows=None):
    """One call of phase 18 (b) under torch.profiler: wall s, cell-hours/s,
    idle share and, streamed, the staging gate and the per-chunk pack /
    copy / convert ms (their range over the chunks).  Returns {"vals",
    "wall", "idle", "chunks"}."""
    Cutout._stream_copies = 0
    torch.cuda.synchronize()
    with profiled() as prof:
        t0 = time.perf_counter()
        res = fn(**kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    vals = np.asarray(res.values)
    if not np.isfinite(vals).all():
        raise RuntimeError(f"{label}: non-finite values")
    idle = device_idle(prof, wall * 1e3)
    log(f"    {label}: {wall:.3f} s = {cells / wall:.4g} cell-hours/s (host work included, "
        f"under torch.profiler); {trace_note(idle)}")
    chunks = None
    if windows is not None:
        chunks, n_pinned = chunk_steps(prof)
        staging_gate(label, chunks, windows)

        def spread(step):
            ms = [c[step] - (c.get("pin", 0.0) if step == "pack" else 0.0)
                  for c in chunks.values() if c[step]]
            return (f"{min(ms):.1f}-{max(ms):.1f} ms ({len(ms)} of {len(chunks)} in the trace)"
                    if ms else "not in the trace")

        log(f"      {len(windows)} chunks, {Cutout._stream_copies} copies to the card counted "
            f"by the streamer ({n_pinned} pinned transfers in the trace): pack "
            f"{spread('pack')}, copy {spread('copy')}, convert {spread('convert')}, "
            f"aggregate {spread('aggregate')} a chunk")
    return {"vals": vals, "wall": wall, "idle": idle and idle[1], "chunks": chunks}


def examples_on_card(card):
    """18 (c): every examples_torch/*.py in a subprocess on the card, all
    started together; rc 0 and some output each.  An example that stops
    only because matplotlib is not installed is reported as not run."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MPLBACKEND="Agg")
    t0 = time.perf_counter()
    procs = {path.stem: subprocess.Popen([sys.executable, str(path)], env=env,
                                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                         text=True)
             for path in sorted(EXAMPLES_DIR.glob("*.py"))}
    ran, not_run, failed = [], [], []
    for name, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        last = out.strip().splitlines()[-1] if out.strip() else ""
        if proc.returncode != 0 and "No module named 'matplotlib'" in err:
            not_run.append(name)
            log(f"    {name}: not run: matplotlib is not installed on this machine")
            continue
        log(f"    {name}: rc {proc.returncode}, {len(out.splitlines())} lines; last: {last[:100]}")
        if proc.returncode == 0 and out.strip():
            ran.append(name)
        else:
            failed.append(name)
            log(f"      stderr: {err[-1500:]}")
    log(f"  (c) {len(ran)} of {len(procs)} examples ran on {card} in "
        f"{time.perf_counter() - t0:.1f} s" + (f"; not run: {not_run}" if not_run else ""))
    if failed:
        raise RuntimeError(f"examples failed on the card: {failed}")
    return {"ran": ran, "not_run": not_run}


def year_phase(card):
    """Phase 18: (a) the full-year gates on the card; (b) a year at the bench
    grid: an OEDB turbine through the stub library against the registry's,
    PV, heat demand and normalized runoff, resident and streamed int16 a
    month at a time, and the fused step at T = 8760 against its plain
    version; (c) the port's examples on the card.  Returns its JSON
    entry."""
    log(f"full year on {card}:")
    gates = year_gates(card)
    gc.collect()

    Y, X = YEAR_GRID
    t0 = time.perf_counter()
    with PeakRSS() as rss:
        cut = Cutout(module="synthetic", time="2013", **YEAR_BOX)
        cut.prepare(features=["wind", "influx", "temperature", "runoff", "height"])
    prep_s = time.perf_counter() - t0
    T = len(cut.grid_desc.time)
    C = Y * X
    if (T,) + cut.shape != (8760, Y, X):
        raise RuntimeError(f"the bench-grid year is {(T,) + cut.shape}")
    matrix = region_matrix(cut, *YEAR_REGIONS)
    B = matrix.shape[0]
    field_gb = T * C * 4 / 1e9
    log(f"  (b) a year at the bench grid: T={T} h, {Y} x {X} cells of 0.25 deg, float32 "
        f"({field_gb:.2f} GB "
        f"a field), {len(cut.data)} variables prepared on the host in {prep_s:.1f} s (peak host "
        f"memory {rss.peak / 1e9:.2f} GB, {(rss.peak - rss.start) / 1e9:.2f} GB above entry); "
        f"({B}, {C}) matrix of {YEAR_REGIONS[0]} x {YEAR_REGIONS[1]} regions, route "
        f"{aggregation_route(matrix)[2]}")
    t0 = time.perf_counter()
    fields = stage_all(cut)
    torch.cuda.synchronize()
    log(f"    resident staging: {len(fields)} fields on the card in "
        f"{time.perf_counter() - t0:.2f} s (set-up)")

    with StubRequests(oedb_rows()) as stub:
        oedb = resource.get_windturbineconfig("oedb:V112")
    name = "Vestas_V112_3000"
    if len(stub.calls) != 1 or resource.windturbines.get(name) is None:
        raise RuntimeError(f"the OEDB search made {len(stub.calls)} requests, registered "
                           f"{name in resource.windturbines}")
    log(f"    OEDB: 'oedb:V112' found {oedb['manufacturer']} {oedb['name']} ({len(oedb['V'])} "
        f"knots, P {oedb['P']} MW, hub {oedb['hub_height']} m) in a stub library of "
        f"{len(stub.rows)} rows (1 request, nothing sent out), registered as {name!r}")

    month = dict(time_chunk=YEAR_CHUNK, stream_pack="int16")
    runoff_stats = {2013: {b: RUNOFF_TOTAL for b in range(B)}}
    calls = {
        "wind oedb": (lambda **k: cut.wind("oedb:V112", matrix=matrix, aggregate_time=None, **k),
                      conv.convert_wind),
        "wind registry": (lambda **k: cut.wind("Vestas_V112_3MW", matrix=matrix,
                                               aggregate_time=None, **k), conv.convert_wind),
        "pv": (lambda **k: cut.pv(panel="CSi", orientation="latitude_optimal", matrix=matrix,
                                  aggregate_time=None, **k), conv.convert_pv),
        "heat demand": (lambda **k: cut.heat_demand(matrix=matrix, aggregate_time=None, **k),
                        conv.convert_heat_demand),
        "runoff": (lambda **k: cut.runoff(matrix=matrix, normalize_using_yearly=runoff_stats,
                                          aggregate_time=None, **k), conv.convert_runoff),
    }
    with StubRequests(oedb_rows()):
        calls["pv"][0](**month)  # set-up: the pinned buffers, sized by PV's chunk
        out, entries = {}, []
        for label, (fn, func) in calls.items():
            windows = [(t0, t1) for t0, t1, _ in conv._stream_windows(cut, func, YEAR_CHUNK, {})]
            for mode, kw in (("resident", {}), ("streamed int16", month)):
                r = year_call(f"{label} {mode}", fn, kw, T * C,
                              windows if mode != "resident" else None)
                out[label, mode] = r["vals"]
                entries.append({"name": label, "mode": mode, "wall_s": r["wall"],
                                "cell_hours_per_s": T * C / r["wall"], "idle": r["idle"]})

    log("    checks:")
    for mode in ("resident", "streamed int16"):
        same = np.array_equal(out["wind oedb", mode], out["wind registry", mode])
        log(f"      wind('oedb:V112') {mode} equals wind('Vestas_V112_3MW') bit for bit: {same}")
        if not same:
            raise RuntimeError(f"the OEDB turbine's {mode} series differ from the registry's")
    for label in ("wind registry", "pv", "heat demand", "runoff"):
        res = out[label, "resident"]
        diff = np.abs(out[label, "streamed int16"] - res)
        scale = float(np.abs(res).max())
        log(f"      {label}: int16 vs resident max {diff.max():.3e}, p999 "
            f"{np.quantile(diff, 0.999):.3e} (max |resident| {scale:.4g})")
        bounds = ((np.quantile(diff, 0.999), 3e-3), (diff.max(), 2e-2)) if label == "pv" else \
            ((diff.max(), 3e-3),)
        for got, rel in bounds:
            if not got < rel * scale:
                raise RuntimeError(f"{label}: int16 vs resident {got} above {rel} * {scale}")
    if out["heat demand", "resident"].shape != (B, 365):
        raise RuntimeError(f"heat demand {out['heat demand', 'resident'].shape}")
    for mode in ("resident", "streamed int16"):
        sums = out["runoff", mode].sum(axis=1)
        log(f"      runoff {mode}: each region's year sums to {sums.min():.6g}..{sums.max():.6g}")
        if not np.allclose(sums, RUNOFF_TOTAL, rtol=1e-5):
            raise RuntimeError(f"runoff {mode} sums {sums} are not {RUNOFF_TOTAL}")
    sub = cut.isel_time(0, 48)
    cpu = Cutout(data=sub.data, grid_desc=sub.grid_desc, attrs=sub.attrs,
                 var_attrs=sub.var_attrs, device="cpu")
    for label, want in (("wind registry", cpu.wind("Vestas_V112_3MW", matrix=matrix,
                                                   aggregate_time=None).values),
                        ("pv", cpu.pv(panel="CSi", orientation="latitude_optimal",
                                      matrix=matrix, aggregate_time=None).values)):
        diff = np.abs(out[label, "resident"][:, :48] - want)
        scale = float(np.abs(want).max())
        log(f"      {label}, first 48 h against the CPU: max {diff.max():.3e} (max |CPU| "
            f"{scale:.4g})")
        bound = REL_TOL if label != "pv" else 2e-2
        if not diff.max() <= bound * scale:
            raise RuntimeError(f"{label}: card vs CPU {diff.max()} above {bound} * {scale}")

    # the fused step at T = 8760 with the OEDB turbine's curve
    dev = fields["wnd100m"].device
    lat = torch.as_tensor(cut.grid_desc.y, dtype=torch.float32, device=dev)
    lon = torch.as_tensor(cut.grid_desc.x, dtype=torch.float32, device=dev)
    V = torch.as_tensor(oedb["V"], dtype=torch.float32, device=dev)
    POWn = torch.as_tensor(oedb["POW"] / oedb["P"], dtype=torch.float32, device=dev)
    dense = torch.as_tensor(matrix.toarray(), dtype=torch.float32, device=dev)
    step_args = ({k: fields[k] for k in FIELD_ORDER}, None, lon, lat, V, POWn, dense)
    step = step_fn()
    wind_pv_bus_megakernel.launches = 0
    got_w, got_p = step(*step_args)
    torch.cuda.synchronize()
    launches = wind_pv_bus_megakernel.launches
    flat, lat_cell, _, _, _ = flat_args(step_args)
    want_w, want_p = wind_pv_bus_plain(flat, lat_cell, dense, V, POWn, PANEL, HUB_HEIGHT)
    err = max(compare("year wind_bus (oedb curve)", got_w, want_w),
              compare("year pv_bus", got_p, want_p))
    ms = cuda_ms(lambda: step(*step_args), reps=10)
    K = V.shape[0]
    n_bytes = 4 * (9 * T * C + C + B * C + 2 * K + 2 * T * B)
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    log(f"    fused step at T={T} ({launches} launch): {ms:.4f} ms = {T * C / ms * 1e3:.4g} "
        f"cell-hours/s; byte bound {bound_ms:.4f} ms ({n_bytes / 1e9:.3f} GB at 3.35 TB/s), "
        f"{bound_ms / ms:.1%} of it; on {card}")
    if launches != 1:
        raise RuntimeError(f"the year's step launched the fused kernel {launches} times")
    del fields, step_args, flat, got_w, got_p, want_w, want_p, dense
    cut = None
    gc.collect()
    torch.cuda.empty_cache()

    examples = examples_on_card(card)
    return {"gates": gates, "grid": [T, Y, X], "B": B, "prepare_s": prep_s,
            "peak_host_gb": rss.peak / 1e9, "calls": entries,
            "step": {"ms": ms, "bound_ms": bound_ms, "launches": launches,
                     "max_abs_err": err},
            "examples": examples, "row_phases": row_phase_timing(card), "card": card}


def row_phase_timing(card, reps=20):
    """Phase 18 (d): the fused kernel at the bench fields' C = 12,288,
    whose rows all start 16-byte aligned, and at their first 12,255 cells,
    whose rows start at every 16-byte phase; B = 20 and 34.  Each shape
    against its plain version, then the kernel's own device time
    (torch.profiler, ``reps`` calls) and the call's (CUDA events).
    Returns its JSON entries."""
    T, Y, X, _ = BENCH_SHAPE
    fields, _, _, lat, V, POWn, matrix = build_inputs(T, Y, X, max(ROW_PHASE_BUSES))
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32), device="cuda")
    V, POWn = put(V), put(POWn)
    log(f"  (d) the fused kernel at T={T} by row phase, on {card}:")
    out = []
    for C in ROW_PHASE_CELLS:
        flat = {k: put(fields[k].reshape(T, -1)[:, :C]) for k in FIELD_ORDER}
        lat_cell = put(np.repeat(lat, X)[:C])
        for B in ROW_PHASE_BUSES:
            m = put(matrix[:B, :C])
            call = lambda: wind_pv_bus_megakernel(flat, lat_cell, m, V, POWn, PANEL, HUB_HEIGHT)
            staged = wind_pv_bus_megakernel.staged16
            got = call()
            staged = wind_pv_bus_megakernel.staged16 - staged
            want = wind_pv_bus_plain(flat, lat_cell, m, V, POWn, PANEL, HUB_HEIGHT)
            err = max(compare(f"wind_bus C={C} B={B}", got[0], want[0]),
                      compare(f"pv_bus C={C} B={B}", got[1], want[1]))
            del got, want
            call_ms = cuda_ms(call, reps)
            kernel_ms = sum(ms for name, ms in device_breakdown(call, reps).items()
                            if "wind_pv_bus_kernel" in name) or None
            log(f"    C={C} (C % 4 = {C % 4}) B={B}: kernel "
                + (f"{kernel_ms:.4f} ms" if kernel_ms else "not measured (no device time)")
                + f", call {call_ms:.4f} ms, staged by 16-byte copies: {staged} of 1 launch")
            out.append({"C": C, "B": B, "kernel_ms": kernel_ms, "call_ms": call_ms,
                        "staged16": staged, "max_abs_err": err})
    return out


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
    jax_diff = against_jax_step(wind_bus, pv_bus)
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
        # the bench's rows start 16-byte aligned: the kernel without kLead staging
        kernel = f"wind_pv_bus_kernel<{tile // 4}, false>"
        regs, st, ld = ptxas["megakernel"][kernel]
        log(f"  B={nb}: {kernel} ({tile} buses a pass): {regs} registers, "
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
    cf, in_memory = continental_path(cut, matrix, card)
    bsr_entry = bsr_phase(matrix, cf, card, ptxas)
    del cf
    t0 = time.perf_counter()
    converters, runoff = converters_phase(cut, matrix, card)
    converters += physics_phase(cut, runoff, card)
    log(f"phase 12: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    converters += gis_phase(cut, card)
    log(f"phase 13: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    converters += store_phase(cut, matrix, card, in_memory)
    log(f"phase 14: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    availability = availability_phase(cut, card)
    log(f"phase 15: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    multi = multidevice_phase(cut, args, nan_args, card)
    log(f"phase 16: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ingest = ingest_phase(cut, matrix, card, in_memory)
    log(f"phase 17: {time.perf_counter() - t0:.1f} s")
    del cut, matrix, in_memory
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    year = year_phase(card)
    log(f"phase 18: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"converters": converters}), flush=True)
    print(json.dumps({"availability": availability}), flush=True)
    print(json.dumps({"multidevice": multi}), flush=True)
    print(json.dumps({"ingest": ingest}), flush=True)
    print(json.dumps({"year": year}), flush=True)
    sharded8 = next(r for r in multi["sharded_step"] if r["shards"] == N_SHARDS)

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
        "sharded_launches": sharded8["launches"],
        "sharded_ms": sharded8["ms"],
        "sharded_unsharded_ms": multi["unsharded_step_ms"],
        "sharded_max_abs_err": multi["err"],
        "jax_step_max_abs_diff": jax_diff,
    }, bsr_entry]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
