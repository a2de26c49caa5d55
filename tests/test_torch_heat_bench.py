"""The benchmark's ``heat`` entry (cells ``eur03-heat`` and ``gb11-heat``)
at a small size on the CPU: a slice of each configuration's lattice, 96 h
(four whole days from midnight), 32 regions.

Held: the port's heat demand, solar thermal and air- and soil-source COP
against the entry's float64 references, within their limits, traced and
untraced; the planted faults of ``h100_bench/heat_control.py`` and the
bfloat16 reference judged not correct; ``Cutout.daily_cell_hours``
growing by T x C a heat-demand call; the heat metrics' byte bound and
the split of the ``aggregate`` spans into the nested daily reduction and
the top-level aggregation, on hand-made numbers and a hand-made trace;
the references on hand-made cases; the new reference modules importing
neither JAX nor the JAX package nor the port.
"""

import ast
import copy
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

CHECKOUT = Path(__file__).resolve().parents[1]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from atlite_tpu_torch import Cutout  # noqa: E402
from h100_bench import heat_control  # noqa: E402
from h100_bench.harness import bench, check, named  # noqa: E402
from h100_bench.harness import cutout as harness_cutout  # noqa: E402
from h100_bench.harness.session import Session  # noqa: E402
from h100_bench.harness.trace import CALL_RANGE, Trace  # noqa: E402

SEED = 2**31 + 99
START = np.datetime64("2013-06-01T00", "ns")
HOURS = 96
# slices of each configuration's lattice that hold sea cells at SEED, so
# that the soil temperature's NaN rule is exercised
BOXES = {"eur03-heat": dict(x=[0.0, 18.9], y=[45.0, 54.3]),
         "gb11-heat": dict(x=[-6.0, 1.7712], y=[50.0, 55.0])}
CELLS = sorted(BOXES)
LABELS = {"heat_demand", "solar_thermal", "cop_air", "cop_soil"}
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def small(monkeypatch):
    """``make(name)``: (cell, small config, traffic, e2e, per-layer) of a
    heat cell, its hours cut to 96, its grid to ``BOXES``, 4 x 8 regions
    and a short traced stretch."""
    spec = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    monkeypatch.setattr(harness_cutout, "hours_of",
                        lambda period: START + np.arange(HOURS) * np.timedelta64(1, "h"))

    def make(name):
        c, config, traffic, e2e, layer = bench.resolve(name, spec)
        config = copy.deepcopy(config)
        config["cutout"].update(BOXES[name])
        config["regions"].update(ny=4, nx=8)
        return c, config, dict(traffic, trace_seconds=0.3), e2e, layer
    return make


def run(cell, trace=0):
    return bench.run_cell(*cell, SEED, 0.3, trace, "cpu")


@pytest.mark.parametrize("name", CELLS)
def test_the_cell_is_found_as_the_traffic_asks(small, name):
    c, config, traffic, e2e, layer = small(name)
    assert c["chips"] == 1 and c["traffic"] == "heat"
    assert c["config"] == {"eur03-heat": "pypsa-eur-2013-0.3deg-heat",
                           "gb11-heat": "atlite-gb-2011-01"}[name]
    assert traffic["entry"] == "heat" and traffic["call_kwargs"] == {"time_chunk": 0}
    assert [call["name"] for call in traffic["calls"]] == ["heat_demand", "solar_thermal",
                                                           "cop_air", "cop_soil"]
    assert {m["name"] for m in e2e} == {"setup_s", "device_peak_gb"}
    assert {m["name"] for m in layer} == {"heat_call_ms", "idle_share.heat", "heat_roofline",
                                          "heat_convert_ms", "heat_daily_ms",
                                          "heat_aggregate_ms"}
    assert all(m["workloads"] == ["eur03-heat", "gb11-heat"] and m["moves"] == "setup_s"
               for m in layer)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(small, name, trace):
    result, checks = run(small(name), trace)
    assert result["correct"], checks
    values = {n: v for n, v, _ in checks}
    assert set(values) == {f"rel_l2.{label}" for label in LABELS} | {
        "nan_mismatch", "unchecked", "failed_calls"}
    assert result["attempted"] >= 4 and result["failed"] == 0
    if trace:
        m = {k: v["value"] for k, v in result["metrics"].items()}
        # the CPU run has no card: no device time, no peak bandwidth
        assert "heat_roofline" not in m and m["idle_share.heat"] == 100.0
        assert m["heat_call_ms"] > 0 and m["heat_convert_ms"] > 0
        assert m["heat_daily_ms"] > 0 and m["heat_aggregate_ms"] > 0
    else:
        assert set(result["metrics"]) == {"setup_s"}


@pytest.mark.parametrize("fault", sorted(heat_control.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_is_not_correct(small, name, fault):
    make, labels = heat_control.FAULTS[fault]
    with make():
        result, checks = run(small(name))
    assert not result["correct"], checks
    failed = {n for n, v, lim in checks if v > lim}
    assert failed and failed <= {f"rel_l2.{label}" for label in labels}, checks


@pytest.mark.parametrize("name", CELLS)
def test_the_bfloat16_reference_fails_every_call(small, name):
    _, config, traffic, _, _ = small(name)
    session = Session(config, traffic, SEED, "cpu")
    gaps = check.control(session, torch.device("cpu"))
    assert set(gaps) == LABELS
    assert all(gap > session.entry.limit(session, label) for label, gap in gaps.items()), gaps


def test_daily_cell_hours_grow_by_the_hours_folded(small):
    _, config, traffic, _, _ = small("gb11-heat")
    session = Session(config, traffic, SEED, "cpu")
    calls = dict(session.calls)
    before = Cutout.daily_cell_hours
    days = calls["heat_demand"]()
    assert days.shape == (32, HOURS // 24)
    assert Cutout.daily_cell_hours - before == HOURS * session.C
    for label in ("solar_thermal", "cop_air", "cop_soil"):
        calls[label]()
    assert Cutout.daily_cell_hours - before == HOURS * session.C
    calls["heat_demand"]()
    assert Cutout.daily_cell_hours - before == 2 * HOURS * session.C
    session.close()


@pytest.mark.parametrize("time_chunk, chunks", [(0, [(0, 96)]), (48, [(0, 48), (48, 96)])])
def test_the_daily_reduction_opens_an_aggregate_span_in_its_converters(small, time_chunk,
                                                                       chunks):
    """Resident or streamed over whole days, each converter span of a heat
    demand call holds one ``aggregate`` span over its own hours."""
    from torch.profiler import ProfilerActivity, profile

    _, config, traffic, _, _ = small("gb11-heat")
    session = Session(config, traffic, SEED, "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        session.state.heat_demand(matrix=session.matrices["population"], per_unit=True,
                                  aggregate_time=None, time_chunk=time_chunk)
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.name.split(" ")[0] in ("convert", "aggregate")]
    converts = [s for s in spans if s[0].startswith("convert")]
    nested = [n for n, a, b in spans if n.startswith("aggregate")
              and any(ca <= a and b <= cb for _, ca, cb in converts)]
    assert sorted(n for n, _, _ in converts) == [f"convert {t0}:{t1}" for t0, t1 in chunks]
    assert sorted(nested) == [f"aggregate {t0}:{t1}" for t0, t1 in chunks]
    session.close()


# ----------------------------------------------------- metrics' arithmetic
def test_heat_byte_bound():
    bound = bench.metric_reader("heat_roofline").__globals__["call_bytes"]
    demand = {"fields": ("temperature",), "T": 8760, "steps": 365, "C": 23711, "B": 512,
              "nnz": 23711}
    solar = dict(demand, fields=named.module("reference", "solar_thermal").FIELDS, steps=8760)
    # one field of 0.8308 GB, the nonzeros (weight + column), 365 days of 512 regions
    assert bound(demand) == 4 * 8760 * 23711 + 8 * 23711 + 4 * 365 * 512
    assert bound(solar) == 4 * 7 * 8760 * 23711 + 8 * 23711 + 4 * 8760 * 512
    assert bound(demand) / 3.35e12 == pytest.approx(0.2483e-3, rel=1e-3)
    assert bound(solar) / 3.35e12 == pytest.approx(1.7409e-3, rel=1e-3)
    cop = named.module("reference", "coefficient_of_performance")
    assert cop.fields({"source": "air"}) == ("temperature",)
    assert cop.fields({"source": "soil"}) == ("soil temperature",)


def heat_trace():
    """A heat-demand call (a) of 1000 us whose ``convert`` span holds the
    nested daily ``aggregate`` [200, 300], then its top-level
    ``aggregate`` [600, 900]; a COP call (b) with a top-level
    ``aggregate`` [1500, 1900] only; the card busy [250, 350] and [1600,
    1800]; a span on another thread that no call owns."""
    host = [(0, 1000, CALL_RANGE + "a", 1), (1000, 2000, CALL_RANGE + "b", 1),
            (100, 500, "convert 0:96", 1), (200, 300, "aggregate 0:96", 1),
            (600, 900, "aggregate 0:96", 1),
            (1100, 1400, "convert 0:96", 1), (1500, 1900, "aggregate 0:96", 1),
            (150, 950, "aggregate 0:96", 2)]
    device = [(250, 350, "index_add_kernel"), (1600, 1800, "gemm")]
    return Trace(device, host)


META = {"a": {"entry": "heat", "method": "heat_demand", "fields": ("temperature",), "T": 96,
              "steps": 4, "C": 1000, "B": 10, "nnz": 1000},
        "b": {"entry": "heat", "method": "coefficient_of_performance",
              "fields": ("temperature",), "T": 96, "steps": 96, "C": 1000, "B": 10,
              "nnz": 1000}}


def metric(name, run):
    return bench.metric_reader(name)(run)


def test_heat_span_metrics_on_a_hand_made_trace():
    run = SimpleNamespace(trace=heat_trace(), meta=META, device_kind=H100)
    # the nested span over the one heat-demand call; the top-level ones over both calls
    assert metric("heat_daily_ms", run) == pytest.approx(0.1)
    assert metric("heat_aggregate_ms", run) == pytest.approx((0.3 + 0.4) / 2)
    assert metric("heat_convert_ms", run) == pytest.approx((0.4 + 0.3) / 2)
    assert metric("idle_share.heat", run) == pytest.approx(100 * (1 - 300 / 2000))
    bytes_ = (4 * 96 * 1000 + 8 * 1000 + 4 * 4 * 10) + (4 * 96 * 1000 + 8 * 1000 + 4 * 96 * 10)
    assert metric("heat_roofline", run) == pytest.approx(100 * bytes_ / 3.35e12 / 300e-6)


def test_heat_span_metrics_of_a_program_without_the_daily_span():
    """A program that opens no nested span (the daily reduction inside
    ``convert`` unmarked) reads no ``heat_daily_ms``; the rest still read."""
    tr = heat_trace()
    tr.host = [h for h in tr.host if h[:2] != (200, 300)]
    run = SimpleNamespace(trace=tr, meta=META, device_kind=H100)
    assert metric("heat_daily_ms", run) is None
    assert metric("heat_aggregate_ms", run) == pytest.approx((0.3 + 0.4) / 2)


@pytest.mark.parametrize("name", ["heat_daily_ms", "heat_aggregate_ms", "heat_convert_ms",
                                  "heat_roofline", "idle_share.heat"])
def test_heat_trace_metrics_read_nothing_without_a_trace(name):
    run = SimpleNamespace(trace=None, meta=META, device_kind=H100)
    assert metric(name, run) is None


# ------------------------------------------------------------ references
def reference(method):
    return named.module("reference", method)


def test_reference_heat_demand_is_the_mean_of_each_days_stamps():
    hours = START + np.arange(48) * np.timedelta64(1, "h")
    t = torch.arange(48 * 3, dtype=torch.float64).reshape(48, 3) / 10 + 280.0
    got = reference("heat_demand").cell_values({"temperature": t}, None,
                                               {"threshold": 15.0, "a": 2.0, "constant": 1.0,
                                                "hour_shift": 0.0}, hours)
    day = t.reshape(2, 24, 3).mean(dim=1)
    want = 1.0 + torch.clamp(2.0 * (288.15 - day), min=0.0)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    with pytest.raises(ValueError):
        reference("heat_demand").cell_values({"temperature": t[1:]}, None, {}, hours[1:])
    with pytest.raises(ValueError):
        reference("heat_demand").cell_values({"temperature": t}, None, {"hour_shift": 1.0},
                                             hours)


def test_reference_cop_zeroes_the_soils_sea():
    soil = torch.tensor([[283.15, float("nan")]], dtype=torch.float64)
    cop = reference("coefficient_of_performance")
    got = cop.cell_values({"soil temperature": soil}, None, {"source": "soil", "sink_T": 55.0})
    # dT = 45 K on land; the sea's source taken as 0 degC, dT = 55 K
    want = [8.77 - 0.150 * dT + 0.000734 * dT**2 for dT in (45.0, 55.0)]
    np.testing.assert_allclose(got.numpy()[0], want, rtol=1e-12)
    air = cop.cell_values({"temperature": soil[:, :1]}, None, {"source": "air", "sink_T": 55.0})
    np.testing.assert_allclose(air.numpy()[0], [6.81 - 0.121 * 45 + 0.000630 * 45**2],
                               rtol=1e-12)


def test_reference_solar_thermal_collector():
    st = reference("solar_thermal")
    sun = {"influx_toa": [1000.0, 1000.0, 0.0], "influx_direct": [600.0, 10.0, 0.0],
           "influx_diffuse": [200.0, 5.0, 0.0], "albedo": [0.2, 0.2, 0.2],
           "solar_altitude": [np.pi / 2, np.pi / 2, -0.3], "solar_azimuth": [np.pi] * 3,
           "temperature": [300.0, 300.0, 280.0]}
    f = {k: torch.tensor([v], dtype=torch.float64) for k, v in sun.items()}
    kwargs = {"orientation": {"slope": 0.0, "azimuth": 180.0}, "c0": 0.8, "c1": 3.0,
              "t_store": 80.0}
    got = st.cell_values(f, torch.zeros(3, dtype=torch.float64), kwargs)[0]
    # a flat panel under the zenith sun takes G = 800 W/m^2; a weak sun
    # gives negative output, set to 0; the night's G = 0 gives 0
    assert float(got[0]) == pytest.approx(800 * 0.8 - 3.0 * (80 + 273.15 - 300))
    assert float(got[1]) == 0.0 and float(got[2]) == 0.0
    with pytest.raises(ValueError):
        st.cell_values(f, torch.zeros(3, dtype=torch.float64), dict(kwargs, trigon_model="other"))


REFERENCE = CHECKOUT / "h100_bench" / "reference"
FORBIDDEN = ("jax", "jaxlib", "atlite_tpu", "atlite_tpu_torch")


@pytest.mark.parametrize("name", ["heat_demand", "coefficient_of_performance", "solar_thermal"])
def test_the_reference_imports_no_jax_and_no_program(name):
    tree = ast.parse((REFERENCE / f"{name}.py").read_text())
    imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    imported |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert not {m for m in imported if m.split(".")[0] in FORBIDDEN}, imported
    probe = (f"import sys; sys.path.insert(0, {str(CHECKOUT)!r}); "
             f"import h100_bench.reference.{name}; "
             f"from h100_bench.harness import named; named.module('entries', 'heat'); "
             f"print(sorted({{m.split('.')[0] for m in sys.modules}} & {set(FORBIDDEN)!r}))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]", out
