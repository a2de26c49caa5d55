"""The port's ``profiling`` against the JAX package's: ``Throughput`` and
``stage_timer`` accumulate and log alike; ``device_trace`` writes a
Chrome trace of the host's activity on every thread (the CPU here; the
card's is added for a CUDA device); ``stage_timer`` synchronises the
card before both clock reads once CUDA is initialised.  Tolerance: exact
for the accumulated counts; the timed seconds are positive."""

import json
import logging

import numpy as np
import scipy.sparse as sp
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


def test_stage_timer_on_a_device(caplog, monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: synced.append("sync"))
    acc = tprof.Throughput()
    with caplog.at_level(logging.INFO, logger=tprof.__name__):
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
        with tprof.stage_timer("convert", cell_hours=1000, accumulator=acc):
            sum(range(1000))
        assert synced == []  # no card: the host's work is done when the clock is read
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        with tprof.stage_timer("copy"):
            synced.append("stage")
    # the card synchronised before the first clock read and before the second
    assert synced == ["sync", "stage", "sync"]
    assert acc.cell_hours == 1000 and acc.seconds > 0
    messages = [r.getMessage() for r in caplog.records if r.name == tprof.__name__]
    assert any(m.startswith("convert: ") and "cell-hours/s" in m for m in messages)
    assert any(m.startswith("copy: ") for m in messages)


def test_device_trace_holds_the_streamers_worker(tmp_path):
    """A streamed call packs each chunk on a worker thread: its ``pack``
    ranges are in the trace, on another thread than the chunks' converts."""
    from atlite_tpu_torch import Cutout

    c = Cutout(device="cpu", module="synthetic", x=slice(-4, 1.5), y=slice(56, 62),
               time="2013-01-01").prepare(features=["wind"])
    m = sp.random(3, c.shape[0] * c.shape[1], density=0.3, random_state=1, format="csr",
                  dtype=np.float32)
    with tprof.device_trace(tmp_path, device="cpu"):
        c.wind("Vestas_V112_3MW", matrix=m, aggregate_time=None, time_chunk=12)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    tid = {e["name"]: e["tid"] for e in events if e.get("ph") == "X"}
    assert {"pack 0:12", "pack 12:24", "convert 0:12", "convert 12:24"} <= set(tid)
    assert tid["pack 12:24"] != tid["convert 12:24"]
