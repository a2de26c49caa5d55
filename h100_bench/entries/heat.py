"""The ``heat`` entry: PyPSA-Eur's heat-sector weather step, the
traffic's ``calls`` (a label, a Cutout method and its arguments) in turn
through ``convert_and_aggregate``, each with the traffic's
``call_kwargs`` (``time_chunk=0``: resident), per unit, each result a
DataArray on the host (regions x steps).  All calls share one matrix of
the configuration's regions, as PyPSA-Eur aggregates every heat series
with one population layout.

``heat_demand`` returns one step a day, so its answer is read as (days,
B).  The reference (``reference/<method>.py``, found by name) runs in
blocks of whole days, ``BLOCK`` hours, each block given its stamps, in
float64 (no TF32: a float64 product never takes it).  The readers of
the entry's spans (``aggregate_spans``) split the ``aggregate`` ranges
of a call into those nested in a ``convert`` range (the daily
reduction) and the rest (the aggregation to regions)."""

from __future__ import annotations

import re

import torch

from h100_bench.harness import cutout, named, spans
from h100_bench.reference import physics

# the convert entry's lookup of a method's reference and its reading of an
# answer, (B, steps) as [(steps, B)]
_convert = named.module("entries", "convert")
method_reference, answers = _convert.method_reference, _convert.answers

MATRIX = "population"  # the one matrix of the calls
BLOCK = 1008  # hours of a reference block: 42 whole days
CONVERT = re.compile(r"^convert \d+:\d+$")
AGGREGATE = re.compile(r"^aggregate \d+:\d+$")


def _call(session, label):
    return next(c for c in session.traffic["calls"] if c["name"] == label)


def build(session):
    cut = session.state = cutout.build(session)
    regions = session.config["regions"]
    extra = dict(session.traffic.get("call_kwargs", {}))
    m = session.matrix(MATRIX, regions["ny"], regions["nx"])
    for spec in session.traffic["calls"]:
        ref = method_reference(spec["method"], session.bench)
        convert = getattr(cut, spec["method"])

        def call(convert=convert, kwargs=spec["kwargs"]):
            return convert(matrix=m, per_unit=True, aggregate_time=None, **kwargs, **extra).values
        session.add(spec["name"], call, {
            "method": spec["method"], "fields": ref.fields(spec["kwargs"]),
            "T": session.T, "steps": session.T // 24 if ref.DAILY else session.T,
            "C": session.C, "B": m.shape[0], "nnz": m.nnz})


def reference(session, label, dtype, device):
    """[(steps, B)] per-unit series of call ``label`` in ``dtype``."""
    spec = _call(session, label)
    ref = method_reference(spec["method"], session.bench)
    names = ref.fields(spec["kwargs"])
    fields = cutout.field_tensors(session, names, device)
    lat = torch.as_tensor(session.lat_cell, device=device).to(dtype)
    m = torch.as_tensor(session.matrices[MATRIX].toarray(), dtype=torch.float64,
                        device=device).to(dtype)
    out = []
    for t0 in range(0, session.T, BLOCK):
        f = {n: fields[n][t0:t0 + BLOCK].to(dtype) for n in names}
        values = ref.cell_values(f, lat, spec["kwargs"], session.times[t0:t0 + BLOCK])
        out.append(physics.aggregate(values, m))
    return [physics.per_unit(torch.cat(out), m)]


def limit(session, label):
    return method_reference(_call(session, label)["method"], session.bench).LIMIT


def aggregate_spans(run):
    """[(label, nested us, top-level us)] of the traced calls of the entry:
    the summed ``aggregate`` spans of each call that lie inside one of
    its ``convert`` spans, and those that do not."""
    if run.trace is None:
        return []
    labels = {a: label for a, _, label in run.trace.calls}
    out = []
    for a, _, events in spans.calls_with_events(run, "heat"):
        converts = [(s, e) for s, e, n in events if CONVERT.match(n)]
        nested = top = 0.0
        for s, e, n in events:
            if AGGREGATE.match(n):
                if any(cs <= s and e <= ce for cs, ce in converts):
                    nested += e - s
                else:
                    top += e - s
        out.append((labels[a], nested, top))
    return out
