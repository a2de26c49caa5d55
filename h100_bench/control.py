"""Readings that the limits of the entries and references are set from.

    python3 h100_bench/control.py --workload <cell> --seeds 1,2,... [--control-seeds 1,2,3]

For each seed: the cell's set-up at its own size, two rounds of its calls
(the timed path's own entry and sizes), and the gaps of their answers to
the float64 reference, as a run reads them (the lower reading); for the
control seeds also the gap of the reference computed in bfloat16, the
precision below the configuration's float32 (the upper reading).  One
JSON line a seed.  The benchmark's runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(CHECKOUT))


def readings(cell, seed, with_control, device="cuda:0", rounds=2):
    import torch

    from h100_bench.harness import bench, check
    from h100_bench.harness.session import Session

    spec = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    _, config, traffic, _, _ = bench.resolve(cell, spec)
    device = torch.device(device)
    t0 = time.perf_counter()
    session = Session(config, traffic, seed, device)
    sampler = check.Sampler(seed, traffic["sample"])
    for _ in range(rounds):
        for label, call in session.calls:
            sampler.offer(label, call())
    t1 = time.perf_counter()
    session.close()
    out = {"workload": cell, "seed": seed, "program_s": t1 - t0,
           "program": {n: v for n, v, _ in check.judge(session, sampler, 0, device)}}
    if with_control:
        out["control"] = check.control(session, device)
    out["check_s"] = time.perf_counter() - t1
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    args = p.parse_args()
    control = {int(s) for s in args.control_seeds.split(",") if s}
    for s in args.seeds.split(","):
        print(json.dumps(readings(args.workload, int(s), int(s) in control)), flush=True)


if __name__ == "__main__":
    main()
