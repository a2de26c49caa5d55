"""The port's ``profiling`` against the JAX package's: ``Throughput`` and
``stage_timer`` accumulate and log alike; ``device_trace`` writes a
Chrome trace of the host's activity (the CPU here; the card's is added
for a CUDA device).  Tolerance: exact for the accumulated counts; the
timed seconds are positive."""

import json
import logging

import torch

import atlite_tpu.profiling as jprof
import atlite_tpu_torch.profiling as tprof

torch.set_num_threads(1)


def test_throughput_and_stage_timer(caplog):
    accs = []
    for mod in (jprof, tprof):
        acc = mod.Throughput()
        assert acc.rate == 0.0
        with caplog.at_level(logging.INFO, logger=mod.__name__):
            with mod.stage_timer("convert", cell_hours=1000, accumulator=acc):
                sum(range(1000))
            with mod.stage_timer("pack"):
                pass
        accs.append(acc)
        assert any(r.name == mod.__name__ and "convert:" in r.getMessage() for r in caplog.records)
    (j, t) = accs
    assert t.cell_hours == j.cell_hours == 1000 and t.seconds > 0 and t.rate > 0
    assert repr(t).startswith("<Throughput ") and repr(t).endswith(" cell-hours/s>")


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with tprof.device_trace(tmp_path / "trace", device="cpu") as logdir:
        torch.ones(64).add_(1).sum()
    assert logdir == tmp_path / "trace"
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any("aten::add_" in e.get("name", "") for e in events)
