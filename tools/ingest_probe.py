"""Phase 17 of chip_smoke.py alone on the card: ERA5-format files written
by the port's encoders from a continental synthetic cut, through
``prepare`` to bus series, checked and timed as chip_smoke.py does.

    PYTHONPATH=. python3 tools/ingest_probe.py [--days N]

``--days`` sets the hours of the files (default chip_smoke.INGEST_DAYS;
30 is one monthly CDS request).  The cut holds just those days, and
phase 10's resident wind and PV series are computed from it first."""

import argparse
import json
import subprocess
import time

import numpy as np

import chip_smoke as cs


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--days", type=int, default=cs.INGEST_DAYS)
    days = parser.parse_args().days
    cs.INGEST_DAYS = days
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    t0 = time.perf_counter()
    end = str(np.datetime64("2013-01-01") + np.timedelta64(days - 1, "D"))
    cut = cs.Cutout(module="synthetic", **cs.continental_kw(slice("2013-01-01", end)))
    cut.prepare(features=["wind", "influx", "temperature", "runoff", "height"])
    matrix = cs.region_matrix(cut, *cs.CONT_REGIONS)
    in_memory = {(n, "resident"): fn(time_chunk=0).values
                 for n, fn in cs.continental_runs(cut, matrix).items()}
    print(f"set-up (the synthetic cut, its matrix and series): {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    entries = cs.ingest_phase(cut, matrix, card, in_memory)
    print(f"phase 17 ({days} days): {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ingest": entries}), flush=True)


if __name__ == "__main__":
    main()
