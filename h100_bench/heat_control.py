"""Readings that the ``heat`` entry's limits are held against.

    python3 h100_bench/heat_control.py --workload eur03-heat --seeds 1,2,3

For each seed, the cell's set-up at its own size, then one round of its
calls on the sound program and one with each planted fault (``FAULTS``,
each named with the calls it touches): the days of the heat demand
shifted by one hour; the heat pump's sink 1 K high; the soil
temperature's sea NaN left in; the solar collector's store 1 K high.
Each round's answers against the float64 reference, and the reference
computed in bfloat16, the precision below the configuration's float32.
One JSON line a seed.  The benchmark's runs do not run this.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np

CHECKOUT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(CHECKOUT))


@contextlib.contextmanager
def patched(module, name, make):
    """``module.<name>`` replaced by ``make(original)`` inside the block."""
    real = getattr(module, name)
    setattr(module, name, make(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def shifted_days():
    """Each hour is folded into the day of the hour after it (the last
    hour keeps its own): every day's mean one hour late."""
    from atlite_tpu_torch.core import timeutil

    def make(real):
        def daily_groups(time, hour_shift=0.0):
            days, ids = real(time, hour_shift)
            return days, np.r_[ids[1:], ids[-1:]].astype(ids.dtype)
        return daily_groups
    return patched(timeutil, "daily_groups", make)


def warm_sink():
    """The heat pump's sink temperature taken 1 K high."""
    from atlite_tpu_torch.physics import thermal

    def make(real):
        return lambda source_T, sink_T, c0, c1, c2: real(source_T, sink_T + 1.0, c0, c1, c2)
    return patched(thermal, "coefficient_of_performance", make)


def sea_nan_kept():
    """The soil temperature's NaN sea cells left NaN."""
    from atlite_tpu_torch.physics import thermal

    return patched(thermal, "soil_temperature_celsius",
                   lambda real: lambda fields: fields["soil temperature"] - thermal.KELVIN)


def warm_store():
    """The solar collector's store temperature taken 1 K high."""
    from atlite_tpu_torch.physics import thermal

    def make(real):
        return lambda irradiation, temperature, c0, c1, t_store: real(
            irradiation, temperature, c0, c1, t_store + 1.0)
    return patched(thermal, "solar_thermal_output", make)


# fault: (context, the call labels it touches)
FAULTS = {"days shifted by one hour": (shifted_days, ("heat_demand",)),
          "sink 1 K high": (warm_sink, ("cop_air", "cop_soil")),
          "sea NaN kept": (sea_nan_kept, ("cop_soil",)),
          "store 1 K high": (warm_store, ("solar_thermal",))}


def one_round(session, labels=None):
    """{label: the host answer} of one call of each label (of ``labels``)."""
    return {label: call() for label, call in session.calls if labels is None or label in labels}


def readings(cell, seed, device="cuda:0"):
    import torch

    from h100_bench.harness import bench, check
    from h100_bench.harness.session import Session

    spec = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    _, config, traffic, _, _ = bench.resolve(cell, spec)
    device = torch.device(device)
    t0 = time.perf_counter()
    session = Session(config, traffic, seed, device)
    rounds = {"sound": one_round(session)}
    for name, (fault, labels) in FAULTS.items():
        with fault():
            rounds[name] = one_round(session, labels)
    t1 = time.perf_counter()
    session.close()
    entry = session.entry
    out = {"workload": cell, "seed": seed, "program_s": t1 - t0, "rel_l2": {}, "nan_mismatch": {}}
    for label in session.meta:
        want = entry.reference(session, label, torch.float64, device)
        for name, answers in rounds.items():
            if label in answers:
                gaps = [check.gaps(g, w) for g, w in zip(entry.answers(answers[label]), want)]
                out["rel_l2"].setdefault(name, {})[label] = max(rel for rel, _ in gaps)
                out["nan_mismatch"].setdefault(name, {})[label] = sum(n for _, n in gaps)
        low = entry.reference(session, label, torch.bfloat16, device)
        out["rel_l2"].setdefault("bfloat16 reference", {})[label] = max(
            check.gaps(g, w)[0] for g, w in zip(low, want))
        del want, low
    out["check_s"] = time.perf_counter() - t1
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args()
    for s in args.seeds.split(","):
        print(json.dumps(readings(args.workload, int(s), args.device)), flush=True)


if __name__ == "__main__":
    main()
