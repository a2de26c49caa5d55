"""Shared pieces of the benchmark's own tests: a small copy of each
configuration, run on the CPU through the program's plain path."""

import copy
import json
import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))


def small(config):
    """The configuration on a 23 x 9 box over one day, 8 regions (the step 3)."""
    c = copy.deepcopy(config)
    c["cutout"].update(x=[-4.0, 1.5], y=[56.0, 58.0], time="2013-06-01")
    if c["cutout"].get("chunksize_time"):
        c["cutout"]["chunksize_time"] = 10
    c["regions"].update(ny=2, nx=4)
    if "step" in c:
        c["step"]["regions"].update(ny=1, nx=3)
    return c


@pytest.fixture(scope="session")
def spec():
    return json.loads((CHECKOUT / "BENCHMARK.json").read_text())


# a cell whose files are in the folder but which BENCHMARK.json does not
# hold yet (PERF.md, Open questions): the convert entry streamed from a store
DORMANT = [
    {"name": "gb11-stream", "config": "atlite-gb-2011-01", "traffic": "stored-chunks",
     "chips": 1, "why": "atlite's example streamed from its store"},
]


@pytest.fixture
def small_cell(spec):
    """(cell, small config, traffic, e2e, per-layer) of a cell by name, the
    dormant cells included."""
    from h100_bench.harness import bench

    full = dict(spec, workloads=spec["workloads"] + DORMANT)

    def make(name):
        cell, config, traffic, e2e, layer = bench.resolve(name, full)
        return cell, small(config), traffic, e2e, layer
    return make
