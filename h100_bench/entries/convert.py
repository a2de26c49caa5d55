"""The ``convert`` entry: ``Cutout.<method>`` through
``convert_and_aggregate``, one call per technology of the configuration
in turn, each result a DataArray on the host (regions x hours, per
unit).  A technology names the Cutout method and its arguments; the
method's plain reference is ``reference/<method>.py``, found by name."""

from __future__ import annotations

import numpy as np
import torch

from h100_bench.harness import cutout, named
from h100_bench.reference import physics


def method_reference(method, bench=named.BENCH):
    return named.module("reference", method, bench)


def build(session):
    cut = session.state = cutout.build(session)
    regions = session.config["regions"]
    extra = dict(session.traffic.get("call_kwargs", {}))
    for tech in session.config["technologies"]:
        ref = method_reference(tech["method"], session.bench)
        m = session.matrix(tech["name"], regions["ny"], regions["nx"])
        convert = getattr(cut, tech["method"])

        def call(convert=convert, m=m, kwargs=tech["kwargs"]):
            return convert(matrix=m, per_unit=True, aggregate_time=None, **kwargs, **extra).values
        session.add(tech["name"], call, {"method": tech["method"], "fields": ref.FIELDS,
                                         "T": session.T, "C": session.C, "B": m.shape[0],
                                         "nnz": m.nnz})


def _tech(session, label):
    return next(t for t in session.config["technologies"] if t["name"] == label)


def reference(session, label, dtype, device):
    """[(T, B)] per-unit series of technology ``label`` in ``dtype``."""
    tech = _tech(session, label)
    ref = method_reference(tech["method"], session.bench)
    lat = torch.as_tensor(session.lat_cell, device=device)
    m = torch.as_tensor(session.matrices[label].toarray(), dtype=torch.float64, device=device)
    fields = cutout.field_tensors(session, ref.FIELDS, device)
    values = lambda f, lat: ref.cell_values(f, lat, tech["kwargs"])  # noqa: E731
    return [physics.series(fields, lat, ref.FIELDS, values, m, dtype)]


def answers(answer):
    """A call's DataArray values, (B, T), as [(T, B)]."""
    return [np.asarray(answer).T]


def limit(session, label):
    return method_reference(_tech(session, label)["method"], session.bench).LIMIT
