"""The ``stream`` entry: ``Cutout.<method>`` through
``convert_and_aggregate`` streamed over time chunks, one call per
technology that the traffic names (``technologies``), in turn, each with
the traffic's ``call_kwargs`` (``time_chunk``, ``stream_pack="int16"``)
and each result a DataArray on the host (regions x hours, per unit).

Every chunk reaches the card as CF int16 codes, so the reference
converts the weather as those codes rebuild it:
each field the method reads goes through ``reference/pack16.py`` (the
rule written anew, in float64) before ``reference/physics.series`` with
the method's reference (``reference/<method>.py``).  Packed against
packed: the codes' rounding is part of the answer, not of the gap.

Each call adds to its ``meta`` what the program's streamer counters
(``Cutout.streamed_bytes``, ``stream_pack_s``, ``stream_wait_s``,
``_stream_copies``) grew by over the call, and counts the call under
``counted``; where the program has no such counter, nothing is recorded
and the metrics that read it give None.  The first call of each label
logs its chunk copies, bytes and seconds."""

from __future__ import annotations

import sys

import torch

from h100_bench.harness import cutout, named
from h100_bench.reference import pack16, physics

# the convert entry's lookup of a method's reference and its reading of an answer
_convert = named.module("entries", "convert")
method_reference, answers = _convert.method_reference, _convert.answers

# relative L2 gap of a per-unit series, the converters' limit; the
# readings it is held against are in PERF.md section 6
LIMIT = 1e-4
COUNTERS = ("streamed_bytes", "stream_pack_s", "stream_wait_s", "_stream_copies")


def counters():
    """{counter: value or None} of the program's streamer."""
    from atlite_tpu_torch import Cutout

    return {k: getattr(Cutout, k, None) for k in COUNTERS}


def _tech(session, label):
    return next(t for t in session.config["technologies"] if t["name"] == label)


def build(session):
    cut = session.state = cutout.build(session)
    regions = session.config["regions"]
    extra = dict(session.traffic.get("call_kwargs", {}))
    for label in session.traffic["technologies"]:
        tech = _tech(session, label)
        ref = method_reference(tech["method"], session.bench)
        m = session.matrix(label, regions["ny"], regions["nx"])
        convert = getattr(cut, tech["method"])

        def call(convert=convert, m=m, kwargs=tech["kwargs"], label=label):
            before = counters()
            out = convert(matrix=m, per_unit=True, aggregate_time=None, **kwargs, **extra).values
            after = counters()
            meta = session.meta[label]
            grown = {k: after[k] - before[k] for k in COUNTERS
                     if before[k] is not None and after[k] is not None}
            for k, v in grown.items():
                meta[k] = meta.get(k, 0) + v
            if len(grown) == len(COUNTERS):
                if not meta.get("counted"):
                    print(f"stream {label}: {grown['_stream_copies']} chunk copies, "
                          f"{grown['streamed_bytes']} B, pack {grown['stream_pack_s']:.3f} s, "
                          f"wait {grown['stream_wait_s']:.3f} s", file=sys.stderr)
                meta["counted"] = meta.get("counted", 0) + 1
            return out
        session.add(label, call, {"method": tech["method"], "fields": ref.FIELDS,
                                  "T": session.T, "C": session.C, "B": m.shape[0],
                                  "nnz": m.nnz})


def packed_fields(session, names, device):
    """{name: (T, C) float64 tensor}: the session's fields as their int16
    codes rebuild them (``pack16``, parameters over the whole year), one
    field at a time: a float64 year beside its float32 upload."""
    return {n: pack16.quantized(cutout.field_tensors(session, [n], device)[n]) for n in names}


def reference(session, label, dtype, device, packed=True):
    """[(T, B)] per-unit series of technology ``label`` in ``dtype``;
    ``packed=False`` converts the stored fields instead (a control)."""
    tech = _tech(session, label)
    ref = method_reference(tech["method"], session.bench)
    lat = torch.as_tensor(session.lat_cell, device=device)
    m = torch.as_tensor(session.matrices[label].toarray(), dtype=torch.float64, device=device)
    fields = (packed_fields(session, ref.FIELDS, device) if packed
              else cutout.field_tensors(session, ref.FIELDS, device))
    values = lambda f, lat: ref.cell_values(f, lat, tech["kwargs"])  # noqa: E731
    return [physics.series(fields, lat, ref.FIELDS, values, m, dtype)]


def limit(session, label):
    return LIMIT


def per_call(run, key):
    """The counter ``key`` summed over the stream entry's counted calls of
    a run, divided by those calls; None where no call counted it."""
    meta = [m for m in run.meta.values()
            if m["entry"] == "stream" and m.get("counted") and key in m]
    if not meta:
        return None
    return sum(m[key] for m in meta) / sum(m["counted"] for m in meta)
