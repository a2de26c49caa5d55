"""The port's spans (``profiling.span``): the ranges a resident
``convert_and_aggregate`` call and the fused step open under a profiler,
their names against the benchmark's pattern for ranges that are not
device work (``h100_bench.harness.trace.RANGE``), and their cost without
a profiler (no range entered at all).  On the CPU, a small synthetic
cutout of one day; exact names and orders."""

import re
import threading
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from atlite_tpu_torch import Cutout, profiling
from atlite_tpu_torch.entry import example_inputs, from_jax_inputs, step_fn
from h100_bench.harness.trace import RANGE

torch.set_num_threads(1)

SPAN = re.compile(r"^(pin|pack|copy|convert|aggregate|mask) (\d+):(\d+)$")
PORT = Path(__file__).resolve().parents[1] / "atlite_tpu_torch"


@pytest.fixture(scope="module")
def small():
    c = Cutout(device="cpu", module="synthetic", x=slice(-4, 1.5), y=slice(56, 62),
               time="2013-01-01").prepare(features=["wind", "influx", "temperature"])
    C = c.shape[0] * c.shape[1]
    m = sp.random(5, C, density=0.3, random_state=3, format="csr", dtype=np.float32)
    return c, m


CALLS = {
    "wind": lambda c, m, **kw: c.wind("Vestas_V112_3MW", matrix=m, per_unit=True,
                                      aggregate_time=None, **kw),
    "pv": lambda c, m, **kw: c.pv("CSi", orientation="latitude_optimal", matrix=m,
                                  per_unit=True, aggregate_time=None, **kw),
}


def profiled():
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))


def spans(prof):
    """[(start, end, step, "t0:t1", thread)] of the program's ranges."""
    out = []
    for e in prof.events():
        m = SPAN.match(e.name)
        if m:
            out.append((e.time_range.start, e.time_range.end, m.group(1),
                        f"{m.group(2)}:{m.group(3)}", e.thread))
    return sorted(out)


class Counting(torch.autograd.profiler.record_function):
    """record_function that keeps the names of the ranges it enters."""
    names = []

    def __enter__(self):
        Counting.names.append(self.name)
        return super().__enter__()


@pytest.fixture
def counted(monkeypatch):
    Counting.names = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    return Counting.names


@pytest.mark.parametrize("method", sorted(CALLS))
def test_resident_call_records_pack_convert_aggregate_and_nested_copies(small, method):
    c, m = small
    CALLS[method](c, m, time_chunk=0)  # the fields staged before the profiled call
    with profiled() as prof:
        CALLS[method](c, m, time_chunk=0)
    got = spans(prof)
    assert {s[3] for s in got} == {"0:24"} and len({s[4] for s in got}) == 1
    top = [s for s in got if not any(o[0] <= s[0] and s[1] <= o[1] and o is not s
                                     for o in got)]
    # the technology lookup in wind()/pv(), then the matrix composition
    assert [s[2] for s in top] == ["pack", "pack", "convert", "aggregate"]
    copies = [s for s in got if s[2] == "copy"]
    assert copies and all(s not in top for s in copies)
    outer = {o[2] for s in copies for o in top if o[0] <= s[0] and s[1] <= o[1]}
    # the curve or the coordinates inside convert, the matrix inside aggregate
    assert outer == {"convert", "aggregate"}


def test_every_range_the_program_opens_is_a_benchmark_range(small, counted):
    c, m = small
    with profiled():
        for call in CALLS.values():
            call(c, m, time_chunk=0)
            call(c, m, time_chunk=10)  # streamed: pin/pack/copy on the worker
        step_fn()(*from_jax_inputs(*example_inputs(T=4), device="cpu"))
    assert {SPAN.match(n).group(1) for n in counted} == {"pack", "copy", "convert",
                                                          "aggregate"}
    assert all(RANGE.match(n) for n in counted), [n for n in counted if not RANGE.match(n)]


def test_the_program_opens_ranges_only_through_span():
    opened = [p.relative_to(PORT) for p in PORT.rglob("*.py")
              if "record_function" in p.read_text() and p.name != "profiling.py"]
    assert opened == []


def test_cpu_step_records_pack_and_no_launch():
    args = from_jax_inputs(*example_inputs(T=4), device="cpu")
    with profiled() as prof:
        step_fn()(*args)
    # the step's argument building; the plain route builds no kernel
    # arguments and launches nothing
    assert [(s[2], s[3]) for s in spans(prof)] == [("pack", "0:4")]


def test_no_profiler_enters_no_range(small, counted):
    c, m = small
    assert not torch.autograd.profiler._is_profiler_enabled
    with profiling.span("pack", 0, 1), profiling.span("copy"):
        pass
    CALLS["wind"](c, m, time_chunk=0)
    step_fn()(*from_jax_inputs(*example_inputs(T=4), device="cpu"))
    assert counted == []


def test_span_on_a_worker_thread_is_recorded():
    def work():
        with profiling.span("pack", 3, 7), profiling.span("copy"):
            torch.ones(4).sum()

    with profiled() as prof:
        t = threading.Thread(target=work)
        t.start()
        t.join()
    got = spans(prof)
    assert [(s[2], s[3]) for s in got] == [("pack", "3:7"), ("copy", "3:7")]
    assert got[0][4] == got[1][4]


def test_span_refuses_other_steps_and_needs_bounds_outside_a_span(counted):
    with pytest.raises(ValueError, match="bogus"):
        profiling.span("bogus", 0, 1)
    with profiled():
        with profiling.span("copy"):  # no span open on this thread: nothing
            pass
        with profiling.span("aggregate", 0, 24), profiling.span("copy"):
            pass
    assert counted == ["aggregate 0:24", "copy 0:24"]
