"""The ``step`` entry: ``entry.step_fn()``, the fused wind + PV +
aggregation step, on the cutout's resident fields, one call per step
matrix in turn, each result the (T, B) wind and PV pair after a
synchronise.  The host's time to enqueue a step is kept for
``enqueue_ms``."""

from __future__ import annotations

import time

import numpy as np
import torch

from h100_bench.harness import cutout, named
from h100_bench.harness.session import sync
from h100_bench.reference import physics

# relative L2 gap of each series; set from the readings in PERF.md
# section 6 (sound runs 1.35e-7, the bfloat16 control 2.71e-3)
LIMIT = 1e-4


def build(session):
    from atlite_tpu_torch.entry import step_fn
    from atlite_tpu_torch.resource import get_windturbineconfig

    s = session.config["step"]
    dev = session.device
    session.state = cutout.build(session)
    fields = session.state.fields()
    lat = torch.as_tensor(session.y, dtype=torch.float32, device=dev)
    turbine = get_windturbineconfig(s["turbine"])
    V = torch.as_tensor(np.asarray(turbine["V"], dtype=np.float32), device=dev)
    POWn = torch.as_tensor(np.asarray(turbine["POW"], dtype=np.float32)
                           / np.float32(turbine["P"]), device=dev)
    step = step_fn()
    enqueue = session.enqueue_s
    for name in s["matrices"]:
        m = session.matrix(name, s["regions"]["ny"], s["regions"]["nx"])
        dense = torch.as_tensor(m.toarray(), device=dev)

        def call(dense=dense):
            t0 = time.perf_counter()
            out = step(fields, None, None, lat, V, POWn, dense)
            enqueue.append(time.perf_counter() - t0)
            sync(dev)
            return out
        session.add(name, call, {"T": session.T, "C": session.C, "B": m.shape[0]})


def reference(session, label, dtype, device):
    """[(T, B) wind, (T, B) PV] of the step with matrix ``label``: the
    V112 at its hub height and latitude-optimal CSi panels, not per unit."""
    s = session.config["step"]
    wind, pv = (named.module("reference", n, session.bench) for n in ("wind", "pv"))
    lat = torch.as_tensor(session.lat_cell, device=device)
    m = torch.as_tensor(session.matrices[label].toarray(), dtype=torch.float64, device=device)
    fields = cutout.field_tensors(session, wind.FIELDS + pv.FIELDS, device)
    techs = ((wind, {"turbine": s["turbine"], "hub_height": s["hub_height"]}),
             (pv, {"panel": s["panel"], "orientation": "latitude_optimal"}))
    return [physics.series(fields, lat, ref.FIELDS,
                           lambda f, lat, ref=ref, kw=kw: ref.cell_values(f, lat, kw),
                           m, dtype, per_unit_=False) for ref, kw in techs]


def answers(answer):
    """A step's (wind, pv) pair of (T, B) tensors."""
    return list(answer)


def limit(session, label):
    return LIMIT
