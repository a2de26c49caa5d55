"""Readings that the ``stream`` entry's limit is held against.

    python3 h100_bench/stream_control.py --workload eur03-stream-int16 --seeds 1,2,3

For each seed, the cell's set-up at its own size, then one round of its
calls on the sound program and one with each planted fault (``FAULTS``:
one window's codes served for the next; one field unpacked with another
field's offset and scale), each round's answers against the packed
float64 reference; the sound answers against the reference given the
stored fields unpacked; and the packed reference computed in bfloat16,
the precision below the configuration's float32.  One JSON line a seed.
The benchmark's runs do not run this.
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
def stale_window(first_stamp):
    """The program packs each call's second window with its first
    window's codes (the window that starts at ``first_stamp``)."""
    from atlite_tpu_torch import Cutout

    real = Cutout._pack
    kept = {}

    def pack(self, dtype, alloc=None):
        batch = real(self, dtype, alloc)
        host, stamps = batch["host"], self.grid_desc.time
        if host is None:
            return batch
        if stamps[0] == first_stamp:
            kept.update(codes=host.clone(), follows=stamps[-1] + np.timedelta64(1, "h"))
        elif "codes" in kept and stamps[0] == kept["follows"] and kept["codes"].shape == host.shape:
            host.copy_(kept.pop("codes"))
        return batch

    Cutout._pack = pack
    try:
        yield
    finally:
        Cutout._pack = real


@contextlib.contextmanager
def swapped_params(first_stamp):
    """The program unpacks the first two fields of each packed window
    with each other's (offset, scale), each keeping its own log flag."""
    del first_stamp
    from atlite_tpu_torch import Cutout

    real = Cutout._unpack

    def unpack(self, batch, dev, dtype):
        p = batch["params"]
        if p is not None and len(p) > 1:
            (o0, s0, l0), (o1, s1, l1) = p[0], p[1]
            batch = dict(batch, params=[(o1, s1, l0), (o0, s0, l1), *p[2:]])
        return real(self, batch, dev, dtype)

    Cutout._unpack = unpack
    try:
        yield
    finally:
        Cutout._unpack = real


FAULTS = {"stale window": stale_window, "swapped pack parameters": swapped_params}


def one_round(session):
    """{label: the host answer} of one call of each label."""
    return {label: call() for label, call in session.calls}


def worst_gap(session, answers, want):
    from h100_bench.harness import check

    return max(check.gaps(got, ref)[0] for label, answer in answers.items()
               for got, ref in zip(session.entry.answers(answer), want[label]))


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
    for name, fault in FAULTS.items():
        with fault(session.times[0]):
            rounds[name] = one_round(session)
    t1 = time.perf_counter()
    entry = session.entry
    out = {"workload": cell, "seed": seed, "program_s": t1 - t0, "rel_l2": {}}
    for label in session.meta:
        want = {label: entry.reference(session, label, torch.float64, device)}
        for name, answers in rounds.items():
            out["rel_l2"].setdefault(name, {})[label] = worst_gap(
                session, {label: answers[label]}, want)
        raw = {label: entry.reference(session, label, torch.float64, device, packed=False)}
        out["rel_l2"].setdefault("raw reference", {})[label] = worst_gap(
            session, {label: rounds["sound"][label]}, raw)
        low = entry.reference(session, label, torch.bfloat16, device)
        out["rel_l2"].setdefault("bfloat16 reference", {})[label] = max(
            check.gaps(g, w)[0] for g, w in zip(low, want[label]))
        del want, raw, low
    out["check_s"] = time.perf_counter() - t1
    session.close()
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
