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
  5. plain version on the card (TF32 off), same tensors: max abs diff
     within 1e-5 * max|plain| per output, NaN masks identical;
  6. NaN cells in ``wnd100m``: the NaN masks of kernel and plain version
     equal "the bus row touches a NaN cell";
  7. ragged shapes (no dimension a tile multiple, and B over one bus
     tile) against the plain version on the card and on the CPU;
  8. timing with CUDA events: the fused step, its cell-hours/s and byte
     bound, the plain version, and the two torch.matmul aggregations
     alone; then the step's device time by kernel from torch.profiler.
Then one JSON line of kernels and, last, the result line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from atlite_tpu_torch import build_inputs, entry, from_jax_inputs
from atlite_tpu_torch.entry import HUB_HEIGHT, PANEL
from atlite_tpu_torch.ops import _build
from atlite_tpu_torch.ops.megakernel import (
    FIELD_ORDER,
    wind_pv_bus_megakernel,
    wind_pv_bus_plain,
)

BENCH_SHAPE = (2184, 96, 128, 20)
RAGGED_SHAPES = ((30, 7, 13, 3), (45, 9, 20, 37))
REL_TOL = 1e-5              # max abs diff allowed, relative to max |plain|
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOPS = 67e12          # H100 SXM data sheet, outside the tensor cores
PHYS_FLOPS = 70             # float ops of the physics chain per cell-hour


def log(msg):
    print(msg, flush=True)


def compare(name, got, want):
    """Max abs diff of two (T, B) series; raises unless the NaN masks are
    identical and the diff is within REL_TOL * max|want|."""
    got, want = got.double().cpu(), want.double().cpu()
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        raise RuntimeError(f"{name}: NaN masks differ")
    ok = ~torch.isnan(want)
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
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / 1e3 / reps for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0}


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
    for name, path in libs.items():
        for line in open(f"{path}.log", encoding="utf-8").read().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

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
    step_ms = cuda_ms(lambda: step(*args), reps=20)
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
    log(f"  plain version {plain_ms:.3f} ms; two torch.matmul aggregations alone "
        f"{matmul_ms:.4f} ms")
    kernel_ms = device_breakdown(lambda: step(*args))
    if kernel_ms:
        busy = sum(kernel_ms.values())
        log(f"  device time of the step by kernel (torch.profiler), {busy:.4f} ms busy, "
            f"idle share {max(0.0, 1 - busy / step_ms):.3f} of the event-timed step:")
        for name, ms in sorted(kernel_ms.items(), key=lambda kv: -kv[1]):
            log(f"    {ms:.4f} ms  {name[:90]}")
    else:
        log("  device time by kernel: not measured (the profiler recorded none)")

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
        "matmul_only_ms": matmul_ms,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
