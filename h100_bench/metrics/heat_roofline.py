"""The heat calls against their byte bound: 100 x the calls' byte bound /
the card's busy time inside those calls, over the traced calls of the
``heat`` entry, at the card's published memory bandwidth.  A call reads
each field its reference reads once (``fields`` of
``reference/<method>.py``, which the entry puts in the call's ``meta``;
4 B a cell-hour), the matrix's nonzeros once (a float32 weight and an
int32 column each) and writes its (steps, B) series once (a step a day
for the heat demand, an hour for the others); the same work whatever
implements it."""

from h100_bench.harness.peaks import hbm_bytes_per_s


def call_bytes(meta):
    T, C, B = meta["T"], meta["C"], meta["B"]
    return 4 * len(meta["fields"]) * T * C + 8 * meta["nnz"] + 4 * meta["steps"] * B


def read(run):
    peak = hbm_bytes_per_s(run.device_kind)
    if run.trace is None or peak is None:
        return None
    bound_s = busy_s = 0.0
    for a, b, label in run.trace.calls:
        meta = run.meta[label]
        if meta["entry"] != "heat":
            continue
        bound_s += call_bytes(meta) / peak
        busy_s += run.trace.busy_us(a, b) / 1e6
    return 100.0 * bound_s / busy_s if busy_s > 0 else None
