"""The readers of the program's spans and the runtime's launches on a
hand-made trace: nested copies inside convert and aggregate, spans on
another thread and outside the calls left out, None without a trace or
without spans."""

from types import SimpleNamespace

import pytest

from h100_bench.harness import bench
from h100_bench.harness.trace import CALL_RANGE, RANGE, Trace

META = {"wind": {"entry": "convert"}, "pv": {"entry": "convert"}, "onwind": {"entry": "step"}}


def metric(name):
    return bench.metric_reader(name)


def span_trace():
    """Convert calls ``wind`` [0, 1000] and ``pv`` [2000, 3000] and a step
    ``onwind`` [1000, 2000] on thread 1; the streamer's worker (2) and the
    host after the last call open spans and launches that no reader may
    count."""
    host = [
        (0, 1000, CALL_RANGE + "wind", 1),
        (10, 60, "pack 0:24", 1),
        (100, 500, "convert 0:24", 1),
        (150, 200, "copy 0:24", 1),
        (160, 170, "cudaMemcpyAsync", 1),
        (210, 215, "cudaLaunchKernel", 1),
        (500, 600, "aten::copy_", 1),
        (600, 900, "aggregate 0:24", 1),
        (650, 700, "copy 0:24", 1),
        (655, 660, "cudaMemcpyAsync", 1),
        (710, 712, "cuLaunchKernelEx", 1),
        (720, 722, "cudaStreamSynchronize", 1),
        (300, 400, "pack 0:24", 2),
        (310, 312, "cudaLaunchKernel", 2),
        (1000, 2000, CALL_RANGE + "onwind", 1),
        (1010, 1100, "pack 0:8760", 1),
        (1150, 1200, "pack 0:8760", 1),
        (1200, 1260, "convert 0:8760", 1),
        (1210, 1220, "cudaLaunchKernel", 1),
        (2000, 3000, CALL_RANGE + "pv", 1),
        (2000, 2100, "pack 0:24", 1),
        (2100, 2900, "convert 0:24", 1),
        (2200, 2210, "cudaLaunchKernelExC", 1),
        (2900, 3000, "aggregate 0:24", 1),
        (3100, 3200, "pack 0:24", 1),
        (3150, 3160, "cudaLaunchKernel", 1),
    ]
    return Trace([(150, 300, "mm")], host)


def test_span_metrics_on_a_hand_made_trace():
    run = SimpleNamespace(trace=span_trace(), meta=META)
    # two convert calls: wind, pv
    assert metric("convert_pack_ms")(run) == pytest.approx((50 + 100) / 1e3 / 2)
    assert metric("convert_host_ms")(run) == pytest.approx((400 + 800) / 1e3 / 2)
    assert metric("aggregate_host_ms")(run) == pytest.approx((300 + 100) / 1e3 / 2)
    assert metric("convert_copy_ms")(run) == pytest.approx((50 + 50) / 1e3 / 2)
    # wind: two copies and two launches; pv: one launch
    assert metric("launches.convert")(run) == pytest.approx(5 / 2)
    # one step
    assert metric("step_pack_ms")(run) == pytest.approx((90 + 50) / 1e3)
    assert metric("step_launch_ms")(run) == pytest.approx(60 / 1e3)
    assert metric("launches.step")(run) == 1


NAMES = ("step_pack_ms", "step_launch_ms", "launches.step", "convert_pack_ms",
         "convert_host_ms", "aggregate_host_ms", "convert_copy_ms", "launches.convert")


@pytest.mark.parametrize("name", NAMES)
def test_span_metrics_read_nothing_without_a_trace(name):
    assert metric(name)(SimpleNamespace(trace=None, meta=META)) is None


def test_span_metrics_read_nothing_of_a_program_without_spans():
    """A program that opens no span: the span readers give nothing, the
    launch readers still count."""
    host = [e for e in span_trace().host
            if not RANGE.match(e[2]) or e[2].startswith("bench:")]
    run = SimpleNamespace(trace=Trace([], host), meta=META)
    for name in NAMES:
        value = metric(name)(run)
        assert (value is not None) == name.startswith("launches."), (name, value)
    assert metric("launches.convert")(run) == pytest.approx(5 / 2)


def test_span_metrics_of_an_entry_without_calls():
    run = SimpleNamespace(trace=span_trace(), meta={k: {"entry": "convert"} for k in META})
    assert metric("step_pack_ms")(run) is None and metric("launches.step")(run) is None


def test_span_metrics_listed_with_their_cells(spec):
    listed = {m["name"]: m for m in spec["per_layer"]}
    for name in NAMES:
        cells = ["eur03-step"] if "step" in name else ["gb11-resident"]
        assert listed[name]["workloads"] == cells
        assert listed[name]["source"] in ("program_span", "device_trace")
