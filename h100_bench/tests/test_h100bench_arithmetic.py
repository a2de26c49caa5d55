"""The metrics' arithmetic on hand-made numbers and a small synthetic
trace."""

from types import SimpleNamespace

import pytest

from h100_bench.harness import bench, named
from h100_bench.harness.trace import CALL_RANGE, Trace, union

H100 = "NVIDIA H100 80GB HBM3"


def metric(name):
    return bench.metric_reader(name)


def test_host_metrics():
    # the window over the calls it completed, not a mean of the calls' own times
    durations = [0.010] * 95 + [0.020] * 5
    assert metric("call_ms")(SimpleNamespace(durations=durations, window_s=1.2)) == pytest.approx(12.0)
    assert metric("setup_s")(SimpleNamespace(setup_s=12.5)) == 12.5
    assert metric("device_peak_gb")(SimpleNamespace(peak_bytes=15_000_000_000)) == 15.0
    assert metric("device_peak_gb")(SimpleNamespace(peak_bytes=None)) is None
    assert metric("enqueue_ms")(SimpleNamespace(enqueue_s=[1e-4, 3e-4])) == pytest.approx(0.2)
    assert metric("enqueue_ms")(SimpleNamespace(enqueue_s=[])) is None


def test_byte_bounds():
    conv = bench.metric_reader("conv_roofline").__globals__
    wind = {"entry": "convert", "fields": named.module("reference", "wind").FIELDS,
            "T": 8760, "C": 23711, "B": 2048, "nnz": 23711}
    pv = dict(wind, fields=named.module("reference", "pv").FIELDS)
    # two fields of 0.8308 GB, the nonzeros (weight + column), the series
    assert conv["call_bytes"](wind) == 4 * 2 * 8760 * 23711 + 8 * 23711 + 4 * 8760 * 2048
    assert conv["call_bytes"](pv) == 4 * 7 * 8760 * 23711 + 8 * 23711 + 4 * 8760 * 2048
    assert conv["call_bytes"](wind) / 3.35e12 == pytest.approx(0.5180e-3, rel=1e-3)
    assert conv["call_bytes"](pv) / 3.35e12 == pytest.approx(1.7568e-3, rel=1e-3)
    step = bench.metric_reader("step_roofline").__globals__
    meta = {"entry": "step", "T": 8760, "C": 23711, "B": 34}
    assert step["step_bytes"](meta) == 4 * (9 * 8760 * 23711 + 34 * 23711 + 2 * 8760 * 34)
    assert step["step_bytes"](meta) / 3.35e12 == pytest.approx(2.2327e-3, rel=1e-3)


def synthetic_trace():
    """Two calls of 1000 us on the main thread (1); the card busy in
    [100, 300] + [250, 400] and [1200, 1700]; a packing range on the
    worker (2); an annotation mirrored on the card (not device work)."""
    host = [(0, 1000, CALL_RANGE + "a", 1), (1000, 2000, CALL_RANGE + "b", 1),
            (500, 900, "aten::copy_", 1), (1750, 1950, "aten::to", 1),
            (100, 160, "pack 0:100", 2), (1100, 1130, "pack 0:100", 2)]
    device = [(100, 300, "void at::native::vectorized_elementwise_kernel<4, Mul>"),
              (250, 400, "ampere_sgemm"), (1200, 1700, "wind_pv_bus_kernel<8>")]
    return Trace(device, host)


def test_trace_reductions():
    tr = synthetic_trace()
    assert union([(5, 6), (1, 3), (2, 4)]) == [(1, 4), (5, 6)]
    assert tr.stretch == (0, 2000) and [c[2] for c in tr.calls] == ["a", "b"]
    assert tr.busy_us() == 300 + 500
    assert tr.busy_us(0, 1000) == 300
    assert tr.device_time("wind_pv_bus") == 500
    ops = dict(tr.top_device_ops())
    assert ops["wind_pv_bus_kernel<8>"] == pytest.approx(5e-4)
    assert ops["Mul>"] == pytest.approx(2e-4)
    gaps = dict(tr.idle_gaps())
    # idle [0, 100] in call a, [400, 1200] named at its middle (copy_), [1700, 2000] under to
    assert gaps == pytest.approx({CALL_RANGE + "a": 1e-4, "aten::copy_": 8e-4,
                                  "aten::to": 3e-4})


def test_trace_metrics():
    tr = synthetic_trace()
    meta = {"a": {"entry": "convert", "fields": ("wnd100m", "roughness"), "T": 100, "C": 1000,
                  "B": 10, "nnz": 1000},
            "b": {"entry": "step", "T": 100, "C": 1000, "B": 10}}
    run = SimpleNamespace(trace=tr, meta=meta, device_kind=H100)
    assert metric("idle_share")(run) == pytest.approx(100 * (1 - 800 / 2000))
    wind_bytes = 4 * 2 * 100 * 1000 + 8 * 1000 + 4 * 100 * 10
    assert metric("conv_roofline")(run) == pytest.approx(100 * wind_bytes / 3.35e12 / 300e-6)
    step_bytes = 4 * (9 * 100 * 1000 + 10 * 1000 + 2 * 100 * 10)
    assert metric("step_roofline")(run) == pytest.approx(100 * step_bytes / 3.35e12 / 500e-6)
    assert metric("pack_ms")(run) == pytest.approx((60 + 30) / 1e3 / 2)
    # no roofline without the card's peak, nothing read without a trace
    assert metric("conv_roofline")(SimpleNamespace(trace=tr, meta=meta, device_kind="cpu")) is None
    assert metric("idle_share")(SimpleNamespace(trace=None)) is None
