"""Tracing and profiling hooks (counterpart of ``atlite_tpu/profiling.py``).

- ``stage_timer``: wall-clock context manager logging a stage's time and,
  given its cell-hours, its grid-cell-hours/s;
- ``Throughput``: accumulator of (cell-hours, seconds) for that rate;
- ``device_trace``: ``torch.profiler`` over the host and, when the
  device is a CUDA card, the card; the trace is written as a Chrome
  trace (``trace.json``) into ``logdir``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import time

import torch

logger = logging.getLogger(__name__)


class Throughput:
    """Accumulate (cell_hours, seconds) and report grid-cell-hours/s."""

    def __init__(self):
        self.cell_hours = 0
        self.seconds = 0.0

    def add(self, cell_hours, seconds):
        self.cell_hours += cell_hours
        self.seconds += seconds

    @property
    def rate(self):
        return self.cell_hours / self.seconds if self.seconds else 0.0

    def __repr__(self):
        return f"<Throughput {self.rate:,.0f} cell-hours/s>"


@contextlib.contextmanager
def stage_timer(name, cell_hours=None, accumulator: Throughput | None = None):
    """Log the wall time (and optional throughput) of a pipeline stage."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if cell_hours is not None:
            logger.info("%s: %.3fs (%.3g cell-hours/s)", name, dt,
                        cell_hours / dt if dt else float("inf"))
            if accumulator is not None:
                accumulator.add(cell_hours, dt)
        else:
            logger.info("%s: %.3fs", name, dt)


@contextlib.contextmanager
def device_trace(logdir=None, device=None):
    """Capture a trace with ``torch.profiler``: the host's activity, and
    the card's when ``device`` (a Cutout's ``device``, or a name) is a CUDA
    device.  Yields ``logdir`` (default: ``atlite_tpu_torch_trace`` in the
    temporary directory) and writes ``trace.json`` there on exit."""
    from torch.profiler import ProfilerActivity, profile

    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "atlite_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield logdir
        finally:
            if device is not None and torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("device trace written to %s", path)
