"""Tracing and profiling hooks (counterpart of ``atlite_tpu/profiling.py``).

- ``stage_timer``: wall-clock context manager logging a stage's time and,
  given its cell-hours, its grid-cell-hours/s; once CUDA is initialised,
  it synchronises the current card before both clock reads;
- ``Throughput``: accumulator of (cell-hours, seconds) for that rate;
- ``device_trace``: ``torch.profiler`` over the host (every thread) and,
  when the device is a CUDA card, the card; the trace is written as a
  Chrome trace (``trace.json``) into ``logdir``;
- ``span``: the program's profiler ranges, named ``"<step> <t0>:<t1>"``
  (the step and the hours it works on), which cost next to nothing
  without a profiler.
"""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import threading
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
    """Log the wall time (and optional throughput) of a pipeline stage.
    Once CUDA is initialised the current card is synchronised before both
    clock reads, so that the time is the stage's work and not its enqueue."""
    cuda = torch.cuda.is_initialized()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if cuda:
            torch.cuda.synchronize()
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
    """Capture a trace with ``torch.profiler``: the host's activity on
    every thread (the streamer's worker included), and the card's when
    ``device`` (a Cutout's ``device``, or a name) is a CUDA device.  Yields
    ``logdir`` (default: ``atlite_tpu_torch_trace`` in the temporary
    directory) and writes ``trace.json`` there on exit."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "atlite_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        try:
            yield logdir
        finally:
            if device is not None and torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("device trace written to %s", path)


# the steps a span may name: the streamer's (pin, pack, copy, convert,
# aggregate) and the availability's mask build; a resident call is the
# one chunk 0:T
SPAN_STEPS = frozenset(("pin", "pack", "copy", "convert", "aggregate", "mask"))
_NO_SPAN = contextlib.nullcontext()
_open = threading.local()  # the (t0, t1) of the spans open on each thread


def span(step, t0=None, t1=None):
    """A profiler range named ``"<step> <t0>:<t1>"`` around a step of a
    call that works on hours [t0, t1) (a resident call is 0:T; a mask
    build, on rows).  Without ``t0``/``t1`` it takes the bounds of the
    innermost span open on this thread, and opens nothing outside one.
    With no profiler active it enters no range at all."""
    if step not in SPAN_STEPS:
        raise ValueError(f"a span's step is one of {sorted(SPAN_STEPS)}, not {step!r}")
    # set process-wide by torch.profiler.profile, so every thread sees it
    if not getattr(torch.autograd.profiler, "_is_profiler_enabled", True):
        return _NO_SPAN
    if t0 is None:
        stack = getattr(_open, "stack", None)
        if not stack:
            return _NO_SPAN
        t0, t1 = stack[-1]
    return _recorded(step, int(t0), int(t1))


@contextlib.contextmanager
def _recorded(step, t0, t1):
    stack = _open.__dict__.setdefault("stack", [])
    stack.append((t0, t1))
    try:
        with torch.autograd.profiler.record_function(f"{step} {t0}:{t1}"):
            yield
    finally:
        stack.pop()
