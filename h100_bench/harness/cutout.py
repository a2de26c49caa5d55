"""A weather cutout as the configuration's ``cutout`` describes it: the
grid by atlite's lattice rule, ERA5-like fields made from the seed on the
device and brought to the host (where a user's cutout lives), and the
program's ``Cutout`` over them, in memory or as an ``.atc`` store in
TMPDIR reopened memory-mapped.  The session keeps the host fields so
that the reference reads the very same after the program's state is
freed."""

from __future__ import annotations

import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from h100_bench.harness.weather import STATIC, Weather, feature_of


def lattice(lo, hi, step, full):
    """atlite's cutout coordinates: the points of a global lattice of
    ``step`` from ``-full`` that lie in [lo, hi]."""
    pts = np.round(np.arange(-full, full, step), 9)
    return pts[(pts >= min(lo, hi)) & (pts <= max(lo, hi))].astype(float)


def hours_of(period):
    """Hourly stamps of a year ("2013"), a month ("2011-01") or a day."""
    start = np.datetime64(period, "h")
    unit = {4: "Y", 7: "M", 10: "D"}[len(period)]
    end = (np.datetime64(period, unit) + 1).astype("datetime64[h]")
    return np.arange(start, end, np.timedelta64(1, "h")).astype("datetime64[ns]")


def build(session):
    """The configuration's Cutout; sets the session's grid (``x``, ``y``,
    ``times``, ``T``, ``C``, ``lat_cell``) and host ``inputs``."""
    c = session.config["cutout"]
    session.x = lattice(*c["x"], c["dx"], 180)
    session.y = lattice(*c["y"], c["dy"], 90)
    session.times = hours_of(c["time"])
    session.T, session.C = len(session.times), len(session.y) * len(session.x)
    session.lat_cell = np.repeat(session.y, len(session.x))
    t0 = time.perf_counter()
    weather = Weather(session.x, session.y, session.times, session.seed, session.device)
    session.inputs = {n: t.cpu().numpy() for n, t in weather.fields(c["variables"])}
    del weather
    if session.device.type == "cuda":
        # the peak that device_peak_gb reads starts here: the program's
        # staging, its warm calls and the window, not the weather made above
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(session.device)
    t1 = time.perf_counter()
    cutout = STORAGE[c["storage"]](session, c)
    session.phases.update(inputs=t1 - t0, cutout=time.perf_counter() - t1)
    return cutout


def _description(session, c):
    from atlite_tpu_torch.core.grid import Grid

    names = session.inputs
    attrs = {"module": c["module"], "dx": c["dx"], "dy": c["dy"], "dt": "h",
             "prepared_features": sorted({feature_of(n) for n in names})}
    if c.get("chunksize_time"):
        attrs["chunksize_time"] = int(c["chunksize_time"])
    var_attrs = {n: {"dims": ("y", "x") if n in STATIC else ("time", "y", "x"),
                     "module": c["module"], "feature": feature_of(n)} for n in names}
    grid = Grid(x=session.x, y=session.y, time=session.times, crs=4326)
    return dict(data=session.inputs, grid_desc=grid, attrs=attrs, var_attrs=var_attrs,
                dtype=c["dtype"], device=session.device)


def _in_memory(session, c):
    from atlite_tpu_torch import Cutout

    return Cutout(**_description(session, c))


def _stored(session, c):
    """Written to an .atc store in TMPDIR and reopened memory-mapped; the
    store goes when the session closes."""
    from atlite_tpu_torch import Cutout

    store = Path(tempfile.mkdtemp(prefix="h100_bench_store"))
    session.cleanups.append(lambda: shutil.rmtree(store, ignore_errors=True))
    Cutout(store / "cutout", **_description(session, c)).to_file()
    return Cutout(store / "cutout", device=session.device)


# a storage kind beyond these comes with an entry of its own, which builds
# its Cutout as it needs
STORAGE = {"memory": _in_memory, "store": _stored}


def field_tensors(session, names, device):
    """{name: (T, C) float32 tensor on ``device``} of the session's inputs."""
    return {n: torch.from_numpy(np.ascontiguousarray(session.inputs[n]))
            .reshape(session.T, session.C).to(device) for n in names}
