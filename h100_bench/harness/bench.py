"""One run of one cell: set-up, the measured window, the traced stretch,
the metrics and the comparison.  Everything a cell needs is found by name
under the benchmark's folder: ``configs/<config>.json``,
``traffic/<mix>.json``, the mix's ``entries/<entry>.py`` (see
``harness/named.py``) and ``metrics/<metric>.py`` (a module with
``read(run) -> float | None``)."""

from __future__ import annotations

import json
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
from torch.profiler import record_function

from h100_bench.harness import check, named
from h100_bench.harness.session import Session, sync
from h100_bench.harness.trace import CALL_RANGE, Trace, profiled

BENCH = named.BENCH
CHECKOUT = BENCH.parent


def load_json(path):
    return json.loads(Path(path).read_text())


def metric_reader(name, bench=BENCH):
    """The ``read`` function of ``metrics/<name>.py``."""
    return named.module("metrics", name, bench).read


def resolve(cell_name, spec, bench=BENCH):
    """(cell, config, traffic, e2e metrics, per-layer metrics) of a cell of
    ``spec`` (the parsed BENCHMARK.json).  A metric with ``workloads``
    belongs to the cells it lists; one without, to every cell that
    reports the end-to-end metric it moves (or, end to end, to all)."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r}; there are {sorted(cells)}")
    cell = cells[cell_name]
    config = load_json(Path(bench) / "configs" / f"{cell['config']}.json")
    traffic = load_json(Path(bench) / "traffic" / f"{cell['traffic']}.json")
    named.module("entries", traffic["entry"], bench)
    e2e = [m for m in spec["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return cell, config, traffic, e2e, layer


def read_metrics(entries, run, bench=BENCH):
    out = {}
    for m in entries:
        value = metric_reader(m["name"], bench)(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def traced_stretch(session, traffic, sampler):
    """Whole rounds of calls under the profiler, for at least the mix's
    ``trace_seconds``; returns the Trace."""
    sync(session.device)
    with profiled() as prof:
        t_end = time.perf_counter() + float(traffic["trace_seconds"])
        while True:
            for label, call in session.calls:
                with record_function(CALL_RANGE + label):
                    sampler.offer(label, call())
            if time.perf_counter() >= t_end:
                break
        sync(session.device)
    return Trace.from_profiler(prof)


def run_cell(cell, config, traffic, e2e, layer, seed, seconds, trace, device,
             t_start=None, bench=BENCH, log=sys.stderr):
    """One run; returns (result dict without ``checks``, checks)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    session = Session(config, traffic, seed, device, bench)
    session.warm()
    sampler = check.Sampler(seed, traffic["sample"])
    setup_s = time.perf_counter() - t_start
    print("set-up " + " ".join(f"{k} {v:.3f} s" for k, v in session.phases.items())
          + f", total {setup_s:.3f} s", file=log)

    durations, labels, failed = [], [], 0
    calls = session.calls
    t_begin = time.perf_counter()
    deadline = t_begin + float(seconds)
    i = 0
    while True:
        label, call = calls[i % len(calls)]
        t0 = time.perf_counter()
        try:
            answer = call()
        except Exception:  # a failed call is counted and judged, not fatal
            traceback.print_exc(file=log)
            failed, answer = failed + 1, None
        t1 = time.perf_counter()
        durations.append(t1 - t0)
        labels.append(label)
        if answer is not None:
            sampler.offer(label, answer)
        i += 1
        if t1 >= deadline and i >= len(calls):
            break
    window_s = t1 - t_begin
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else None

    run = SimpleNamespace(setup_s=setup_s, durations=durations, labels=labels,
                          window_s=window_s, peak_bytes=peak, meta=session.meta,
                          enqueue_s=list(session.enqueue_s), trace=None,
                          device_kind=torch.cuda.get_device_name(device) if cuda else "cpu")
    breakdown = None
    if trace:
        run.trace = traced_stretch(session, traffic, sampler)
        lo, hi = run.trace.stretch
        run.busy_s, run.traced_s = run.trace.busy_us() / 1e6, (hi - lo) / 1e6
        metrics = read_metrics(layer, run, bench)
        breakdown = {"device_ops": run.trace.top_device_ops(),
                     "idle_gaps": run.trace.idle_gaps()}
    else:
        metrics = read_metrics(e2e, run, bench)

    session.close()
    t_check = time.perf_counter()
    checks = check.judge(session, sampler, failed, device)
    spread = {label: np.percentile([d for d, n in zip(durations, labels) if n == label],
                                   [10, 50, 90]) * 1e3 for label in session.meta}
    print(f"window {window_s:.3f} s, {len(durations)} calls; ms p10/p50/p90 "
          + ", ".join(f"{k} {a:.2f}/{b:.2f}/{c:.2f}" for k, (a, b, c) in spread.items())
          + f"; comparison {time.perf_counter() - t_check:.3f} s", file=log)
    result = {
        "correct": all(v <= lim for _, v, lim in checks),
        "attempted": len(durations),
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu", "kind": run.device_kind,
                   "count": int(cell["chips"]), "memory_peak_bytes": peak},
    }
    if trace:
        result["device"].update(busy_s=run.busy_s, window_s=run.traced_s)
        result["breakdown"] = breakdown
    return result, checks
